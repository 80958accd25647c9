// Block-coherent screen-space hemisphere march (SSAO and SSR indirect
// diffuse), the march that phase-2 training runs (GIParams.backend "pallas").
//
// Replaces: gi_gs_tpu/ops/pallas_gi.py:_march_pallas(mode="coherent")
//   (_kernel_coherent, pallas_gi.py:260-373) with its block-centre offset
//   table (_centre_offset_table, pallas_gi.py:380-431). Per (16 x 128 pixel
//   block, direction d, step j) every pixel of the block samples the
//   z-buffer at its own position plus ONE offset (dy, dx): the block
//   centre's projected march offset. The centre is taken in the G-buffer
//   zero-padded to (16, 128) multiples (a centre in the padding is a zero
//   normal at the origin). The hit test stays per pixel: the pixel's own
//   unit normal gives the z row of its TBN (svz), its marched depth is
//   spz = posz + svz * (j * zsc) with zsc = (1 + posz / 100)^2 * radius /
//   step; an out-of-bounds sample (pixel + offset outside the image) kills
//   the ray before the depth test; z - thick <= zbuf <= z + bias is a hit,
//   adds the direction's weight (and, for SSR, weight * rgb at the sample)
//   and stops the ray. RGB is read as f32; the TPU kernel's 11-11-10
//   packing was a VMEM workaround.
//
// Bound on the H100: operations (about 8 flops and one z-buffer load per
//   live sample, ~25 flops per key; the inputs and outputs are a few MB);
//   in practice instruction issue.
// Design:
// - Keys on the card. A march block's nd x (step - start) offsets are built
//   in the kernel's prologue with the f32 operations of the plain
//   screen_space.centre_offset_table in its order (march_walk.cuh; the
//   z / 100 of the centre's scale is z * f32(0.01) there), clipped to
//   +-2047, and kept decoded in shared memory as (dx, dy): the loop
//   decodes nothing.
// - One thread per pixel; a CTA is 128 x 2 pixels of one march block, so
//   the offset of (block, d, j) is the same for every thread and every warp
//   reads 32 consecutive z (and RGB) texels: coalesced. The 8 CTAs of a
//   march block form a cluster: each builds an eighth of the block's
//   offsets and copies the other seven eighths from its peers' shared
//   memory, so each key is built once per march block.
// - The walk (march_walk.cuh) is lock-step per (d, j), which keeps the
//   loads coalesced. tools/march_variants.py builds, by text substitution,
//   the designs that were measured against this one (PERF.md): the
//   per-lane walk, no cluster (each CTA builds all its block's keys) and a
//   keys-only pre-pass.
// - `keys_out` (optional) receives the packed keys
//   (dy + 2048) * 4096 + (dx + 2048), int32 [nby, nbx, nd, step - start],
//   as the plain table holds them; the march runs either way.
#include <cooperative_groups.h>

#include "common.cuh"
#include "march_walk.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gigs_march;

constexpr int kBH = 16;      // march block height (pallas_gi.BH)
constexpr int kBW = 128;     // march block width (pallas_gi.BW)
constexpr int kRows = 2;     // pixel rows per CTA
constexpr int kCTAs = kBH / kRows;  // per block, one cluster
constexpr int kCluster = kCTAs;     // CTAs sharing a block's keys
constexpr int kThreads = kBW * kRows;
constexpr int kKoff = 2048;  // key bias (pallas_gi._KOFF)

// The block centre's geometry (screen_space.centre_offset_table).
struct Centre {
  Tbn f;
  float3 p;
  float zsc, x, y;
};

__device__ __forceinline__ Centre block_centre(const float* nrm,
                                               const float* pos, int h, int w,
                                               int by, int bx, float zsc_k) {
  const int ci = by * kBH + kBH / 2, cj = bx * kBW + kBW / 2;
  float n[3] = {0.0f, 0.0f, 0.0f}, p[3] = {0.0f, 0.0f, 0.0f};
  if (ci < h && cj < w) {
    const int hw = h * w, i = ci * w + cj;
    for (int c = 0; c < 3; ++c) {
      n[c] = nrm[c * hw + i];
      p[c] = pos[c * hw + i];
    }
  }
  Centre c;
  c.f = make_tbn(n[0], n[1], n[2]);
  c.p = make_float3(p[0], p[1], p[2]);
  const float t = 1.0f + p[2] * 0.01f;
  c.zsc = t * t * zsc_k;
  c.x = static_cast<float>(cj);
  c.y = static_cast<float>(ci);
  return c;
}

// torch.clamp(v, -2047, 2047) (NaN passes), then .to(int32) on the card
// (NaN -> 0).
__device__ __forceinline__ int clip_offset(float v) {
  if (v == v) v = fminf(fmaxf(v, -(kKoff - 1.0f)), kKoff - 1.0f);
  return static_cast<int>(v);
}

// Offset of step j of direction dv from the block centre, (dx, dy).
__device__ __forceinline__ int2 centre_offset(const Centre& c, float4 dv,
                                              int j, float fx, float fy,
                                              float cx, float cy) {
  float qx, qy;
  project(c.p, rotate(c.f, dv), static_cast<float>(j) * c.zsc, fx, fy, cx,
          cy, qx, qy);
  return make_int2(clip_offset(round_half_away(qx) - c.x),
                   clip_offset(round_half_away(qy) - c.y));
}

// Copies the other CTAs' shares of the block's offsets (entries
// [r * total / kCluster, (r + 1) * total / kCluster) of rank r) from their
// shared memory into this CTA's.
__device__ __forceinline__ void gather_offsets(int2* soff, int rank,
                                               int total, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();     // every share built
  for (int r = 0; r < kCluster; ++r) {
    if (r == rank) continue;
    const int2* peer = cluster.map_shared_rank(soff, r);
    const int lo = r * total / kCluster, hi = (r + 1) * total / kCluster;
    for (int e = lo + tid; e < hi; e += kThreads) soff[e] = peer[e];
  }
  cluster.sync();     // no CTA leaves while a peer still reads it
}

// One pixel's march against its block's decoded offsets.
template <bool kRGB>
struct CoherentMarch {
  const float4* dirs;
  const int2* offs;
  const float* zbuf;
  const float* rgb;
  int x, y, ns;
  unsigned w, h, hw;
  float pz, zs, tz, bz, nz, bias, thick;
  const int2* doff;
  float svz, wgt;
  float o = 0.0f, dr = 0.0f, dg = 0.0f, db = 0.0f;

  __device__ __forceinline__ void dir(int d) {
    const float4 dv = dirs[d];
    svz = dv.x * tz + dv.y * bz + dv.z * nz;
    wgt = dv.w;
    doff = offs + d * ns;
  }

  __device__ __forceinline__ bool sample(int jj, float fj) {
    const int2 off = doff[jj];
    const unsigned ix = x + off.x, iy = y + off.y;
    if (ix >= w || iy >= h) return true;     // negative: past 2^31
    const float spz = pz + svz * (fj * zs);
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
__global__ void __launch_bounds__(kThreads) __cluster_dims__(1, kCTAs, 1)
    gi_march_coherent_kernel(
        const float* __restrict__ nrm, const float* __restrict__ pos,
        const float* __restrict__ rgb, const float4* __restrict__ dirs,
        const float* __restrict__ zbuf, int nd, int h, int w, float fx,
        float fy, float cx, float cy, float zsc_k, float bias, float thick,
        int start, int step, float* __restrict__ occ,
        float* __restrict__ dif, int* __restrict__ keys_out) {
  extern __shared__ float4 smem[];
  float4* sdirs = smem;
  int2* soff = reinterpret_cast<int2*>(smem + nd);
  const int tid = threadIdx.y * kBW + threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y / kCTAs;
  const int sub = blockIdx.y % kCTAs;
  const int ns = step > start ? step - start : 0;
  const int total = nd * ns;
  for (int i = tid; i < nd; i += kThreads) sdirs[i] = dirs[i];
  __syncthreads();

  // this CTA's share of the block's offsets: entries [lo, hi) of d * ns + jj
  const int rank = sub % kCluster;
  const int lo = rank * total / kCluster, hi = (rank + 1) * total / kCluster;
  {
    const Centre c = block_centre(nrm, pos, h, w, by, bx, zsc_k);
    int* kout = keys_out != nullptr
                    ? keys_out + static_cast<size_t>(by * gridDim.x + bx) * total
                    : nullptr;
    for (int e = lo + tid; e < hi; e += kThreads) {
      const int d = e / ns, jj = e - d * ns;
      const int2 off = centre_offset(c, sdirs[d], start + jj, fx, fy, cx, cy);
      soff[e] = off;
      if (kout != nullptr)
        kout[e] = (off.y + kKoff) * (2 * kKoff) + (off.x + kKoff);
    }
  }
  gather_offsets(soff, rank, total, tid);

  const int x = bx * kBW + threadIdx.x;
  const int y = by * kBH + sub * kRows + threadIdx.y;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int i = y * w + x;

  CoherentMarch<kRGB> m;
  m.dirs = sdirs;
  m.offs = soff;
  m.zbuf = zbuf;
  m.rgb = rgb;
  m.x = x;
  m.y = y;
  m.w = w;
  m.h = h;
  m.hw = hw;
  m.ns = ns;
  m.bias = bias;
  m.thick = thick;
  const Tbn f = make_tbn(nrm[i], nrm[hw + i], nrm[2 * hw + i]);
  m.tz = f.tz;
  m.bz = f.bz;
  m.nz = f.nz;
  m.pz = m.zbuf[i];
  const float zs = 1.0f + m.pz / 100.0f;
  m.zs = zs * zs * zsc_k;
  walk(m, nd, start, ns);
  occ[i] = m.o;
  if (kRGB) {
    dif[i] = m.dr;
    dif[hw + i] = m.dg;
    dif[2 * hw + i] = m.db;
  }
}

size_t smem_bytes(int nd, int ns) {
  return static_cast<size_t>(nd) * sizeof(float4) +
         static_cast<size_t>(nd) * (ns > 0 ? ns : 0) * sizeof(int2);
}

// Lets both instantiations take up to the card's opt-in maximum of dynamic
// shared memory: once per device.
cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_once_per_device(device, done, [device] {
    int bytes = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gi_march_coherent_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gi_march_coherent_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    return err;
  });
}

}  // namespace

GIGS_API int gigs_gi_march_coherent(
    int device, const void* nrm, const void* pos, const void* rgb,
    const void* dirs, int nd, int h, int w, float fx, float fy, float cx,
    float cy, float zsc_k, float bias, float thick, int start, int step,
    void* occ, void* dif, void* keys_out, void* stream) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nbx = (w + kBW - 1) / kBW;
  const int nby = (h + kBH - 1) / kBH;
  const dim3 block(kBW, kRows);
  const dim3 grid(nbx, nby * kCTAs);
  const size_t smem = smem_bytes(nd, step - start);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<const float*>(nrm);
  const auto p = static_cast<const float*>(pos);
  const auto c = static_cast<const float*>(rgb);
  const auto d = static_cast<const float4*>(dirs);
  const auto k = static_cast<int*>(keys_out);
  const float* z = p + 2 * static_cast<size_t>(h) * w;  // as in gi_march.cu
  if (rgb != nullptr)
    gi_march_coherent_kernel<true><<<grid, block, smem, s>>>(
        n, p, c, d, z, nd, h, w, fx, fy, cx, cy, zsc_k, bias, thick, start,
        step, static_cast<float*>(occ), static_cast<float*>(dif), k);
  else
    gi_march_coherent_kernel<false><<<grid, block, smem, s>>>(
        n, p, c, d, z, nd, h, w, fx, fy, cx, cy, zsc_k, bias, thick, start,
        step, static_cast<float*>(occ), static_cast<float*>(dif), k);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM of the SSAO
// (with_rgb 0) or SSR (1) instantiation for nd directions of ns steps
// (gigs_kernel_resources), plus the cluster size and the clusters the card
// holds at once.
GIGS_API int gigs_gi_march_coherent_resources(int device, int with_rgb,
                                              int nd, int ns, int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = with_rgb ? gi_march_coherent_kernel<true>
                         : gi_march_coherent_kernel<false>;
  const size_t smem = smem_bytes(nd, ns);
  const int rc = gigs_kernel_resources(kernel, kThreads, smem, out);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, kCTAs * 64);
  cfg.blockDim = dim3(kBW, kRows);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[6] = kCluster;
  out[7] = clusters;
  return 0;
}
