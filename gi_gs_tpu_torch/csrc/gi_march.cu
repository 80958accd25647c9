// Screen-space hemisphere ray march (SSAO and SSR indirect diffuse).
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
// Bound on the H100: operations (about 30 flops and one data-dependent
//   z-buffer load per live sample); the inputs and outputs are a few MB.
// Design: one thread per pixel, 16 x 16 pixel blocks. The direction table
//   [Nd, 4] is staged in shared memory once per block and read as a
//   broadcast. The z-buffer and RGB planes (2.6 MB and 7.7 MB at 800x800)
//   stay resident in the 50 MB L2, and neighbouring pixels sample
//   neighbouring texels, so the random loads hit L1/L2.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBlock = 16;

__device__ __forceinline__ float round_half_away(float x) {
  return truncf(x + (x >= 0.0f ? 0.5f : -0.5f));
}

__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / n;
  y = y / n;
  z = z / n;
}

__global__ void __launch_bounds__(kBlock * kBlock) gi_march_kernel(
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ rgb, const float4* __restrict__ dirs, int nd,
    int h, int w, float fx, float fy, float cx, float cy, float zsc_k,
    float bias, float thick, int start, int step, float* __restrict__ occ,
    float* __restrict__ dif) {
  extern __shared__ float4 sdirs[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nd; i += blockDim.x * blockDim.y) sdirs[i] = dirs[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int i = y * w + x;

  float nx = nrm[i], ny = nrm[hw + i], nz = nrm[2 * hw + i];
  unit3(nx, ny, nz);
  // Gram-Schmidt TBN from up = (0, 1, 0) (forward.cu:661-675).
  float tx = -nx * ny, ty = 1.0f - ny * ny, tz = -nz * ny;
  unit3(tx, ty, tz);
  float bx = ny * tz - nz * ty, by = nz * tx - nx * tz, bz = nx * ty - ny * tx;
  unit3(bx, by, bz);

  const float px = pos[i], py = pos[hw + i], pz = pos[2 * hw + i];
  const float* zbuf = pos + 2 * hw;
  float zs = 1.0f + pz / 100.0f;
  zs = zs * zs * zsc_k;
  const float xmax = static_cast<float>(w - 1);
  const float ymax = static_cast<float>(h - 1);

  float o = 0.0f, dr = 0.0f, dg = 0.0f, db = 0.0f;
  for (int d = 0; d < nd; ++d) {
    const float4 dv = sdirs[d];
    const float svx = dv.x * tx + dv.y * bx + dv.z * nx;
    const float svy = dv.x * ty + dv.y * by + dv.z * ny;
    const float svz = dv.x * tz + dv.y * bz + dv.z * nz;
    for (int j = start; j < step; ++j) {
      const float s = static_cast<float>(j) * zs;
      const float spx = px + svx * s;
      const float spy = py + svy * s;
      const float spz = pz + svz * s;
      const float zz = spz + 1e-7f;
      const float ixf = round_half_away(spx / zz * fx + cx);
      const float iyf = round_half_away(spy / zz * fy + cy);
      if (ixf < 0.0f || ixf > xmax || iyf < 0.0f || iyf > ymax) break;
      const int idx = static_cast<int>(iyf) * w + static_cast<int>(ixf);
      const float sample = zbuf[idx];
      if (sample <= spz + bias && sample >= spz - thick) {
        o += dv.w;
        if (rgb != nullptr) {
          dr += dv.w * rgb[idx];
          dg += dv.w * rgb[hw + idx];
          db += dv.w * rgb[2 * hw + idx];
        }
        break;
      }
    }
  }
  occ[i] = o;
  if (dif != nullptr) {
    dif[i] = dr;
    dif[hw + i] = dg;
    dif[2 * hw + i] = db;
  }
}

}  // namespace

GIGS_API int gigs_gi_march(
    int device, const void* nrm, const void* pos, const void* rgb,
    const void* dirs, int nd, int h, int w, float fx, float fy, float cx,
    float cy, float zsc_k, float bias, float thick, int start, int step,
    void* occ, void* dif, void* stream) {
  cudaSetDevice(device);
  const dim3 block(kBlock, kBlock);
  const dim3 grid((w + kBlock - 1) / kBlock, (h + kBlock - 1) / kBlock);
  const size_t smem = static_cast<size_t>(nd) * sizeof(float4);
  gi_march_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nrm), static_cast<const float*>(pos),
      static_cast<const float*>(rgb), static_cast<const float4*>(dirs), nd, h,
      w, fx, fy, cx, cy, zsc_k, bias, thick, start, step,
      static_cast<float*>(occ), static_cast<float*>(dif));
  GIGS_RETURN_LAUNCH_STATUS();
}
