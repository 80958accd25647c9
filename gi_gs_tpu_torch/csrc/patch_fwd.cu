// Locally connected halo filter of the GGX prefilter:
//   out[f, c, y, x] = sum_{dy, dx} W[f, dy * P + dx, y, x] * pad[f, c, y + dy, x + dx]
//
// Replaces: gi_gs_tpu/ops/pallas_patch.py:patch_apply_fwd (_fwd_kernel).
//   W [6, P^2, R, R] is the static weight table of cubemap._patch_tables;
//   pad [6, 3, R + 2h, R + 2h] the halo-padded faces (P = 2h + 1).
//
// Bound on the H100: bytes. W is read once (6 P^2 R^2 floats: 354 MB at
//   R = 256, P = 15; 661 MB at R = 128, P = 41) against 6 flops per weight.
// Design: one thread per output texel (f, y, x) computing its three
//   channels; 32 x 8 texel blocks. The W loads of a warp are 32
//   consecutive floats of one row for every offset (coalesced). Each block
//   stages its padded input window ((8 + 2h) x (32 + 2h) x 3 floats, at
//   most 83 KB for h = 32) in dynamic shared memory once, so the P^2
//   neighbourhood reads never touch global memory. Offsets accumulate in
//   order p = 0 .. P^2 - 1, as the plain version does.
#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__global__ void __launch_bounds__(kBX * kBY) patch_fwd_kernel(
    const float* __restrict__ W, const float* __restrict__ pad,
    float* __restrict__ out, int R, int P, int h) {
  extern __shared__ float win[];  // [3][kBY + 2h][kBX + 2h]
  const int f = blockIdx.z;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int E = R + 2 * h;
  const int WX = kBX + 2 * h;
  const int WY = kBY + 2 * h;
  const int plane = WX * WY;
  const float* padf = pad + static_cast<size_t>(f) * 3 * E * E;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int e = tid; e < 3 * plane; e += kBX * kBY) {
    const int c = e / plane;
    const int r = (e - c * plane) / WX;
    const int q = e - c * plane - r * WX;
    const int gy = y0 + r;
    const int gx = x0 + q;
    win[e] = (gy < E && gx < E)
                 ? padf[(static_cast<size_t>(c) * E + gy) * E + gx]
                 : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= R || y >= R) return;
  const size_t rr = static_cast<size_t>(R) * R;
  const float* wp = W + static_cast<size_t>(f) * P * P * rr +
                    static_cast<size_t>(y) * R + x;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int dy = 0; dy < P; ++dy) {
    const float* row = win + (threadIdx.y + dy) * WX + threadIdx.x;
    for (int dx = 0; dx < P; ++dx) {
      const float wv = wp[static_cast<size_t>(dy * P + dx) * rr];
      a0 += row[dx] * wv;
      a1 += row[plane + dx] * wv;
      a2 += row[2 * plane + dx] * wv;
    }
  }
  float* o = out + static_cast<size_t>(f) * 3 * rr + static_cast<size_t>(y) * R + x;
  o[0] = a0;
  o[rr] = a1;
  o[2 * rr] = a2;
}

cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_opt_in_smem(device, done, patch_fwd_kernel);
}

}  // namespace

GIGS_API int gigs_patch_fwd(int device, const void* W, const void* pad,
                            void* out, int R, int P, int h, void* stream) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(3) * (kBY + 2 * h) * (kBX + 2 * h) * sizeof(float);
  const dim3 block(kBX, kBY);
  const dim3 grid((R + kBX - 1) / kBX, (R + kBY - 1) / kBY, 6);
  patch_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(pad),
      static_cast<float*>(out), R, P, h);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM at a level's halo h
// (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_patch_fwd_resources(int device, int h, int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(3) * (kBY + 2 * h) * (kBX + 2 * h) * sizeof(float);
  return gigs_kernel_resources(patch_fwd_kernel, kBX * kBY, smem, out);
}
