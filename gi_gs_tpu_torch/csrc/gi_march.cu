// Screen-space hemisphere ray march (SSAO and SSR indirect diffuse), the
// exact march of serving and evaluation (GIParams.backend "pallas_exact").
//
// Replaces: gi_gs_tpu/ops/pallas_gi.py:_march_pallas(mode="exact")
//   (_kernel). Semantics of the jnp oracle
//   gi_gs_tpu/ops/screen_space.py:_march: per direction, march
//   j = start..step-1 along the TBN-rotated direction scaled by
//   (1 + z/100)^2 * radius/step; project with +1e-7 on z and round half
//   away from zero; an out-of-bounds sample kills the ray before the depth
//   test; a sample with z - thick <= zbuf <= z + bias is a hit, adds the
//   direction's weight (and, for SSR, weight * rgb at the hit) and stops
//   the ray. Outputs occ = sum_d w_d hit_d [H, W] and dif [3, H, W].
//   The TPU kernel's 11-11-10 RGB packing was a VMEM workaround; this
//   kernel reads f32 RGB, as the CUDA SSRCUDA reference does.
//
// Bound on the H100: operations (about 20 flops per live sample and one
//   data-dependent z-buffer load); in practice instruction issue: each
//   live sample keeps its two IEEE divisions (spx / zz, spy / zz), which
//   bit-exactness against the plain version needs, plus ~30 other
//   instructions. The inputs and outputs are a few MB.
// Design: one thread per pixel in 16 x 16 blocks (8x32, 32x8 and 32x4 were
//   slower, PERF.md). The direction table [Nd, 4] is staged in shared
//   memory and read as a broadcast; the z-buffer and RGB planes (2.6 and
//   7.7 MB at 800x800) stay in the 50 MB L2. The walk is lock-step per
//   (direction, step) (march_walk.cuh): lanes of a warp hardly diverge, and
//   a per-lane walk over each pixel's flattened sequence was slower
//   (tools/march_variants.py). Each pixel's sums keep the table's order.
#include "common.cuh"
#include "march_walk.cuh"

namespace {

using namespace gigs_march;

constexpr int kBX = 16;
constexpr int kBY = 16;

// One pixel's march: its position, TBN and z scale, the direction being
// walked and the sums.
template <bool kRGB>
struct ExactMarch {
  const float4* dirs;
  const float* zbuf;
  const float* rgb;
  unsigned w, h, hw;
  float fx, fy, cx, cy, bias, thick, zs;
  Tbn f;
  float3 p, v;
  float wgt;
  float o = 0.0f, dr = 0.0f, dg = 0.0f, db = 0.0f;

  __device__ __forceinline__ void dir(int d) {
    const float4 dv = dirs[d];
    v = rotate(f, dv);
    wgt = dv.w;
  }

  __device__ __forceinline__ bool sample(int, float fj) {
    float qx, qy;
    const float spz = project(p, v, fj * zs, fx, fy, cx, cy, qx, qy);
    const unsigned ix = round_half_away_int(qx);
    const unsigned iy = round_half_away_int(qy);
    if (ix >= w || iy >= h) return true;     // negative: past 2^31
    const unsigned idx = iy * w + ix;
    const float z = zbuf[idx];
    if (z <= spz + bias && z >= spz - thick) {
      o += wgt;
      if (kRGB) {
        dr += wgt * rgb[idx];
        dg += wgt * rgb[hw + idx];
        db += wgt * rgb[2 * hw + idx];
      }
      return true;
    }
    return false;
  }
};

template <bool kRGB>
__global__ void __launch_bounds__(kBX * kBY) gi_march_kernel(
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ rgb, const float4* __restrict__ dirs,
    const float* __restrict__ zbuf, int nd, int h, int w, float fx, float fy,
    float cx, float cy, float zsc_k, float bias, float thick, int start,
    int step, float* __restrict__ occ, float* __restrict__ dif) {
  extern __shared__ float4 sdirs[];
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < nd; i += kBX * kBY) sdirs[i] = dirs[i];
  __syncthreads();

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int i = y * w + x;

  ExactMarch<kRGB> m;
  m.dirs = sdirs;
  m.zbuf = zbuf;
  m.rgb = rgb;
  m.w = w;
  m.h = h;
  m.hw = hw;
  m.fx = fx;
  m.fy = fy;
  m.cx = cx;
  m.cy = cy;
  m.bias = bias;
  m.thick = thick;
  m.f = make_tbn(nrm[i], nrm[hw + i], nrm[2 * hw + i]);
  m.p = make_float3(pos[i], pos[hw + i], pos[2 * hw + i]);
  const float zs = 1.0f + m.p.z / 100.0f;
  m.zs = zs * zs * zsc_k;
  walk(m, nd, start, step - start);
  occ[i] = m.o;
  if (kRGB) {
    dif[i] = m.dr;
    dif[hw + i] = m.dg;
    dif[2 * hw + i] = m.db;
  }
}

// Lets both instantiations take up to the card's opt-in maximum of dynamic
// shared memory (a direction table past 48 KB): once per device.
cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_once_per_device(device, done, [device] {
    int bytes = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gi_march_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gi_march_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    return err;
  });
}

}  // namespace

GIGS_API int gigs_gi_march(
    int device, const void* nrm, const void* pos, const void* rgb,
    const void* dirs, int nd, int h, int w, float fx, float fy, float cx,
    float cy, float zsc_k, float bias, float thick, int start, int step,
    void* occ, void* dif, void* stream) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  const size_t smem = static_cast<size_t>(nd) * sizeof(float4);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<const float*>(nrm);
  const auto p = static_cast<const float*>(pos);
  const auto c = static_cast<const float*>(rgb);
  const auto d = static_cast<const float4*>(dirs);
  const float* z = p + 2 * static_cast<size_t>(h) * w;  // its own pointer:
  // the sample's address is then one multiply-add from a uniform register
  if (rgb != nullptr)
    gi_march_kernel<true><<<grid, block, smem, s>>>(
        n, p, c, d, z, nd, h, w, fx, fy, cx, cy, zsc_k, bias, thick, start,
        step, static_cast<float*>(occ), static_cast<float*>(dif));
  else
    gi_march_kernel<false><<<grid, block, smem, s>>>(
        n, p, c, d, z, nd, h, w, fx, fy, cx, cy, zsc_k, bias, thick, start,
        step, static_cast<float*>(occ), static_cast<float*>(dif));
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM of the SSAO
// (with_rgb 0) or SSR (1) instantiation for `nd` directions
// (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_gi_march_resources(int device, int with_rgb, int nd,
                                     int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(nd) * sizeof(float4);
  return with_rgb ? gigs_kernel_resources(gi_march_kernel<true>, kBX * kBY,
                                          smem, out)
                  : gigs_kernel_resources(gi_march_kernel<false>, kBX * kBY,
                                          smem, out);
}
