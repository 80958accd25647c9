// Block-coherent screen-space hemisphere march (SSAO and SSR indirect
// diffuse), the march that phase-2 training runs (GIParams.backend "pallas").
//
// Replaces: gi_gs_tpu/ops/pallas_gi.py:_march_pallas(mode="coherent")
//   (_kernel_coherent, pallas_gi.py:260-373). Per (16 x 128 pixel block,
//   direction d, step j) every pixel of the block samples the z-buffer at
//   its own position plus ONE offset (dy, dx): the block centre's projected
//   march offset, packed as key = (dy + 2048) * 4096 + (dx + 2048) in the
//   int32 table keys [nby, nbx, nd, nsteps] that
//   screen_space.centre_offset_table builds on the card (JAX builds it
//   outside its kernel too). The hit test stays per pixel: the pixel's own
//   unit normal gives the z row of its TBN (svz), its marched depth is
//   spz = posz + svz * (j * zsc) with zsc = (1 + posz / 100)^2 * radius /
//   step; an out-of-bounds sample (pixel + offset outside the image) kills
//   the ray before the depth test; z - thick <= zbuf <= z + bias is a hit,
//   adds the direction's weight (and, for SSR, weight * rgb at the sample)
//   and stops the ray. RGB is read as f32; the TPU kernel's 11-11-10
//   packing was a VMEM workaround.
//
// Bound on the H100: operations (about 13 flops and one z-buffer load per
//   live sample; the inputs and outputs are a few MB).
// Design: one thread per pixel; a thread block is 128 x 2 pixels of one
//   16 x 128 march block, so the offset of (block, d, j) is the same for
//   every thread and every warp reads 32 consecutive z (and RGB) texels:
//   coalesced, where the exact march's per-pixel offsets scatter. The
//   block stages its direction rows (16 B each) and its keys (nd * nsteps
//   int32, 16 KB at the default 512 x 8) in shared memory.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBH = 16;      // march block height (pallas_gi.BH)
constexpr int kBW = 128;     // march block width (pallas_gi.BW)
constexpr int kRows = 2;     // pixel rows per thread block
constexpr int kKoff = 2048;  // key bias (pallas_gi._KOFF)

__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / n;
  y = y / n;
  z = z / n;
}

__global__ void __launch_bounds__(kBW * kRows) gi_march_coherent_kernel(
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ rgb, const float4* __restrict__ dirs,
    const int* __restrict__ keys, int nd, int ns, int nbx, int h, int w,
    float zsc_k, float bias, float thick, int start, int step,
    float* __restrict__ occ, float* __restrict__ dif) {
  extern __shared__ float4 smem[];
  float4* sdirs = smem;
  int* skeys = reinterpret_cast<int*>(smem + nd);
  const int bx = blockIdx.x;
  const int by = blockIdx.y / (kBH / kRows);
  const int tid = threadIdx.y * kBW + threadIdx.x;
  const int* bkeys = keys + static_cast<size_t>(by * nbx + bx) * nd * ns;
  for (int i = tid; i < nd; i += kBW * kRows) sdirs[i] = dirs[i];
  for (int i = tid; i < nd * ns; i += kBW * kRows) skeys[i] = bkeys[i];
  __syncthreads();

  const int x = bx * kBW + threadIdx.x;
  const int y = by * kBH + (blockIdx.y % (kBH / kRows)) * kRows + threadIdx.y;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int i = y * w + x;

  float nx = nrm[i], ny = nrm[hw + i], nz = nrm[2 * hw + i];
  unit3(nx, ny, nz);
  // z rows of the Gram-Schmidt TBN from up = (0, 1, 0) (forward.cu:661-675)
  float tx = -nx * ny, ty = 1.0f - ny * ny, tz = -nz * ny;
  unit3(tx, ty, tz);
  float bxv = ny * tz - nz * ty, byv = nz * tx - nx * tz,
        bzv = nx * ty - ny * tx;
  unit3(bxv, byv, bzv);

  const float* zbuf = pos + 2 * hw;
  const float pz = zbuf[i];
  float zs = 1.0f + pz / 100.0f;
  zs = zs * zs * zsc_k;

  float o = 0.0f, dr = 0.0f, dg = 0.0f, db = 0.0f;
  for (int d = 0; d < nd; ++d) {
    const float4 dv = sdirs[d];
    const float svz = dv.x * tz + dv.y * bzv + dv.z * nz;
    const int* dkeys = skeys + d * ns;
    for (int j = start; j < step; ++j) {
      const int key = dkeys[j - start];
      const int ix = x + (key % (2 * kKoff) - kKoff);
      const int iy = y + (key / (2 * kKoff) - kKoff);
      if (ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1) break;
      const float spz = pz + svz * (static_cast<float>(j) * zs);
      const int idx = iy * w + ix;
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

GIGS_API int gigs_gi_march_coherent(
    int device, const void* nrm, const void* pos, const void* rgb,
    const void* dirs, const void* keys, int nd, int ns, int h, int w,
    float zsc_k, float bias, float thick, int start, int step, void* occ,
    void* dif, void* stream) {
  cudaSetDevice(device);
  const int nbx = (w + kBW - 1) / kBW;
  const int nby = (h + kBH - 1) / kBH;
  const size_t smem = static_cast<size_t>(nd) * sizeof(float4) +
                      static_cast<size_t>(nd) * ns * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gi_march_coherent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBW, kRows);
  const dim3 grid(nbx, nby * (kBH / kRows));
  gi_march_coherent_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nrm), static_cast<const float*>(pos),
      static_cast<const float*>(rgb), static_cast<const float4*>(dirs),
      static_cast<const int*>(keys), nd, ns, nbx, h, w, zsc_k, bias, thick,
      start, step, static_cast<float*>(occ), static_cast<float*>(dif));
  GIGS_RETURN_LAUNCH_STATUS();
}
