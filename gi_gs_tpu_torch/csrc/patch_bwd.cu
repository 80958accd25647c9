// Transpose of the GGX prefilter's locally connected halo filter:
//   pad_bar[f, c, Y, X] = sum_{dy, dx} g[f, c, Y - dy, X - dx] * W[f, dy * P + dx, Y - dy, X - dx]
// over the offsets whose source texel (Y - dy, X - dx) lies in [0, R)^2.
//
// Replaces: gi_gs_tpu/ops/pallas_patch.py:patch_apply_bwd (_bwd_kernel,
//   pallas_patch.py:61-80), the scatter form
//   pad_bar[f, c, y + dy, x + dx] += g[f, c, y, x] * W[f, p, y, x].
//   W [6, P^2, R, R] is the static weight table of cubemap._patch_tables,
//   g [6, 3, R, R] the cotangent of the filtered level, pad_bar
//   [6, 3, R + 2h, R + 2h] the cotangent of the halo-padded faces
//   (P = 2h + 1).
//
// Bound on the H100: bytes. W is read once (6 P^2 R^2 floats: 354 MB at
//   R = 256, P = 15; 661 MB at R = 128, P = 41; 319 MB at R = 64, P = 57)
//   against 6 flops per weight.
// Design: the gather form, one thread per padded output texel (f, Y, X)
//   computing its three channels; 32 x 8 texel blocks. Each W element is
//   read by exactly one thread, and a warp's W loads for one offset are 32
//   consecutive floats of one row (coalesced). Each block stages the g
//   window it reads ((8 + 2h) x (32 + 2h) x 3 floats, at most 68 KB for
//   h = 28) in dynamic shared memory. No atomics: the result is
//   deterministic, and the offsets accumulate in order p = 0 .. P^2 - 1 as
//   the plain version adds them.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__global__ void __launch_bounds__(kBX * kBY) patch_bwd_kernel(
    const float* __restrict__ W, const float* __restrict__ g,
    float* __restrict__ out, int R, int P, int h) {
  extern __shared__ float win[];  // [3][kBY + 2h][kBX + 2h]
  const int f = blockIdx.z;
  const int X0 = blockIdx.x * kBX;
  const int Y0 = blockIdx.y * kBY;
  const int E = R + 2 * h;
  const int WX = kBX + 2 * h;
  const int WY = kBY + 2 * h;
  const int plane = WX * WY;
  const float* gf = g + static_cast<size_t>(f) * 3 * R * R;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int e = tid; e < 3 * plane; e += kBX * kBY) {
    const int c = e / plane;
    const int r = (e - c * plane) / WX;
    const int q = e - c * plane - r * WX;
    const int gy = Y0 - 2 * h + r;
    const int gx = X0 - 2 * h + q;
    win[e] = (gy >= 0 && gy < R && gx >= 0 && gx < R)
                 ? gf[(static_cast<size_t>(c) * R + gy) * R + gx]
                 : 0.0f;
  }
  __syncthreads();

  const int X = X0 + threadIdx.x;
  const int Y = Y0 + threadIdx.y;
  if (X >= E || Y >= E) return;
  const size_t rr = static_cast<size_t>(R) * R;
  const float* wf = W + static_cast<size_t>(f) * P * P * rr;
  const int dy0 = max(0, Y - R + 1), dy1 = min(P - 1, Y);
  const int dx0 = max(0, X - R + 1), dx1 = min(P - 1, X);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int dy = dy0; dy <= dy1; ++dy) {
    const int y = Y - dy;
    const float* row = win + (threadIdx.y + 2 * h - dy) * WX + threadIdx.x +
                       2 * h;
    for (int dx = dx0; dx <= dx1; ++dx) {
      const float wv =
          wf[static_cast<size_t>(dy * P + dx) * rr + static_cast<size_t>(y) * R +
             (X - dx)];
      a0 += row[-dx] * wv;
      a1 += row[plane - dx] * wv;
      a2 += row[2 * plane - dx] * wv;
    }
  }
  const size_t ee = static_cast<size_t>(E) * E;
  float* o = out + static_cast<size_t>(f) * 3 * ee + static_cast<size_t>(Y) * E + X;
  o[0] = a0;
  o[ee] = a1;
  o[2 * ee] = a2;
}

}  // namespace

GIGS_API int gigs_patch_bwd(int device, const void* W, const void* g,
                            void* out, int R, int P, int h, void* stream) {
  cudaSetDevice(device);
  const size_t smem =
      static_cast<size_t>(3) * (kBY + 2 * h) * (kBX + 2 * h) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      patch_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = R + 2 * h;
  const dim3 block(kBX, kBY);
  const dim3 grid((E + kBX - 1) / kBX, (E + kBY - 1) / kBY, 6);
  patch_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(g),
      static_cast<float*>(out), R, P, h);
  GIGS_RETURN_LAUNCH_STATUS();
}
