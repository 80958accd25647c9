// The SH colour of N Gaussians and its backward (ops/sh._SHColour on CUDA
// tensors): one launch each way.
//
// Replaces: no Pallas kernel. JAX's sh_to_rgb (gi_gs_tpu/ops/sh.py:74) is
//   jnp math that XLA fuses. As PyTorch ops on the card (ops/sh.py's plain
//   twin, which CPU tensors keep) the colour was ~140 launches over strided
//   [N] columns, [N, 16] stacks of the basis, [N, 15, 3] products and sums,
//   and ~0.8 GB of saved intermediates at 8.4 M slots: 29 ms of a
//   bicycle.train_p2 step, 25x its least bytes.
// Computes, per slot, in the plain twin's order of operations on the card,
//   so that the results are its bits (-fmad=false rounds every product and
//   sum alone, as PyTorch's one-op kernels do):
//   sh_fwd: d = mean - campos; n2 = (d0 d0 + d2 d2) + d1 d1 (PyTorch's sum
//     of 3 contiguous floats: lanes {0, 2} and {1}, then one shuffle);
//     inv = rsqrt(max(n2, MIN_NORM2)); the basis of d * inv at the active
//     degree; rgb = C0 dc + S + 0.5, S the sum over the active rest rows
//     (PyTorch's sum over a middle dimension: four accumulators, row j into
//     j % 4, then ((a0 + a1) + a2) + a3); clamped at 0. Writes the colour
//     alone: the backward recomputes the rest from the inputs.
//   sh_bwd: recomputes the same, passes the colour's gradient g as
//     torch.maximum(rgb, 0) passes it (whole above, half at a tie, none
//     below), writes g_dc = C0 g, g_rest = basis_k g (zeros past the
//     active degree) and g_means: the direction's gradient from
//     v_k = (r_k0 g0 + r_k2 g2) + r_k1 g1 through the basis' derivatives,
//     less its part along the direction (passed at MIN_NORM2 as g is at
//     0), times inv.
// Bound on the H100: bytes. At degree 3 with 15 rest rows the forward reads
//   204 B and writes 12 B a slot, the backward reads 216 B and writes
//   204 B: 636 B a slot, 5.34 GB over bicycle's 8.39 M slots, 1.59 ms at
//   3.35 TB/s. The arithmetic (~450 flops a slot) would take 0.06 ms.
// Design: one CTA per tile of 128 consecutive slots, one thread a slot.
//   The tile's rows of features_rest, features_dc and means are one
//   contiguous block each: the CTA stages them into shared memory with
//   16-byte cp.async copies, coalesced (a thread reading its own 180-byte
//   row from device memory would touch a line per lane). Each thread
//   computes from its own rows there (45 and 3 floats are odd word
//   strides: no bank conflicts), writes its outputs in place of its
//   inputs, and the CTA stores the blocks with 16-byte stores. 26 KB of
//   shared memory a CTA: eight CTAs of the forward (six of the backward,
//   at 80 registers) a SM keep 150-200 KB of loads in flight, and the pair
//   ran at 80-90% of the HBM rate on bicycle's shapes. Templated on the
//   active degree; the stored rest rows are a run-time argument (15 on
//   bicycle, 3 on garden). The incoming gradient is read where it lies,
//   through its two strides (on the training path a column-major slice of
//   the compositing table's gradient: coalesced). campos is read on the
//   device: no host sync.
#include "common.cuh"

#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // slots of one CTA, one a thread
constexpr int kMaxRows = 15;    // stored rest rows at degree 3

// PyTorch rounds a Python float multiplier to float from its double, and
// Python multiplies two floats (2.0 * SH_C2[2]) in double first.
#define GIGS_F(v) static_cast<float>(v)
constexpr float kMinNorm2 = GIGS_F(1e-24);
constexpr float C0 = GIGS_F(0.28209479177387814);
constexpr float C1 = GIGS_F(0.4886025119029199);
constexpr float NC1 = GIGS_F(-0.4886025119029199);
constexpr double D20 = 1.0925484305920792, D21 = -1.0925484305920792,
                 D22 = 0.31539156525252005, D23 = -1.0925484305920792,
                 D24 = 0.5462742152960396;
constexpr double D30 = -0.5900435899266435, D31 = 2.890611442640554,
                 D32 = -0.4570457994644658, D33 = 0.3731763325901154,
                 D34 = -0.4570457994644658, D35 = 1.445305721320277,
                 D36 = -0.5900435899266435;
constexpr float C20 = GIGS_F(D20), C21 = GIGS_F(D21), C22 = GIGS_F(D22),
                C23 = GIGS_F(D23), C24 = GIGS_F(D24);
constexpr float C30 = GIGS_F(D30), C31 = GIGS_F(D31), C32 = GIGS_F(D32),
                C33 = GIGS_F(D33), C34 = GIGS_F(D34), C35 = GIGS_F(D35),
                C36 = GIGS_F(D36);
#undef GIGS_F

__host__ __device__ constexpr int basis_size(int deg) {
  return (deg + 1) * (deg + 1);
}

size_t smem_bytes(int rows) {
  return static_cast<size_t>(kTile) * (3 * rows + 6) * sizeof(float);
}

// Copies nf floats from device memory at src to shared memory at dst (16-
// byte aligned): 16-byte cp.async copies where src is 16-byte aligned too,
// the last nf % 4 (or all, where it is not) one float at a time. The
// caller commits, waits and syncs.
__device__ __forceinline__ void stage_in(float* dst,
                                         const float* __restrict__ src,
                                         int nf) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = nf >> 2;
    for (int i = threadIdx.x; i < nv; i += kTile)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    done = nv << 2;
  }
  for (int i = done + threadIdx.x; i < nf; i += kTile) dst[i] = src[i];
}

// The way back: 16-byte stores where dst is 16-byte aligned.
__device__ __forceinline__ void stage_out(float* __restrict__ dst,
                                          const float* src, int nf) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = nf >> 2;
    for (int i = threadIdx.x; i < nv; i += kTile)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = nv << 2;
  }
  for (int i = done + threadIdx.x; i < nf; i += kTile) dst[i] = src[i];
}

struct Direction {
  float x, y, z, n2, inv;
};

__device__ __forceinline__ Direction direction(
    const float* m, const float* __restrict__ campos) {
  const float d0 = m[0] - __ldg(campos), d1 = m[1] - __ldg(campos + 1),
              d2 = m[2] - __ldg(campos + 2);
  const float n2 = (d0 * d0 + d2 * d2) + d1 * d1;
  // clamp_min keeps a NaN
  const float inv = rsqrtf(n2 < kMinNorm2 ? kMinNorm2 : n2);
  return {d0 * inv, d1 * inv, d2 * inv, n2, inv};
}

// sh_basis: the basis values with the 3DGS sign conventions.
template <int kDeg>
__device__ __forceinline__ void sh_basis(const Direction& u,
                                         float (&b)[basis_size(kDeg)]) {
  const float x = u.x, y = u.y, z = u.z;
  b[0] = C0;
  if constexpr (kDeg > 0) {
    b[1] = NC1 * y;
    b[2] = C1 * z;
    b[3] = NC1 * x;
  }
  if constexpr (kDeg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C20 * xy;
    b[5] = C21 * yz;
    b[6] = C22 * ((2.f * zz - xx) - yy);
    b[7] = C23 * xz;
    b[8] = C24 * (xx - yy);
    if constexpr (kDeg > 2) {
      b[9] = (C30 * y) * (3.f * xx - yy);
      b[10] = (C31 * xy) * z;
      b[11] = (C32 * y) * ((4.f * zz - xx) - yy);
      b[12] = (C33 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      b[13] = (C34 * x) * ((4.f * zz - xx) - yy);
      b[14] = (C35 * z) * (xx - yy);
      b[15] = (C36 * x) * (xx - 3.f * yy);
    }
  }
}

// One channel of the colour before its clamp; r is the channel's first
// rest value (rows 3 floats apart).
template <int kDeg>
__device__ __forceinline__ float colour(const float (&b)[basis_size(kDeg)],
                                        float dc, const float* r) {
  float v = b[0] * dc;
  if constexpr (kDeg > 0) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < basis_size(kDeg) - 1; ++j)
      acc[j & 3] = acc[j & 3] + b[j + 1] * r[3 * j];
    v = v + (((acc[0] + acc[1]) + acc[2]) + acc[3]);
  }
  return v + 0.5f;
}

// sh_basis_grad: the gradient to the direction from v, the gradient to
// the basis values past the constant one.
template <int kDeg>
__device__ __forceinline__ void basis_grad(
    const Direction& u, const float (&v)[basis_size(kDeg) - 1], float& gx,
    float& gy, float& gz) {
  const float x = u.x, y = u.y, z = u.z;
  gx = NC1 * v[2];
  gy = NC1 * v[0];
  gz = C1 * v[1];
  if constexpr (kDeg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx = gx + ((((C20 * y) * v[3] - (float(2.0 * D22) * x) * v[5]) +
                (C23 * z) * v[6]) +
               (float(2.0 * D24) * x) * v[7]);
    gy = gy + ((((C20 * x) * v[3] + (C21 * z) * v[4]) -
                (float(2.0 * D22) * y) * v[5]) -
               (float(2.0 * D24) * y) * v[7]);
    gz = gz + (((C21 * y) * v[4] + (float(4.0 * D22) * z) * v[5]) +
               (C23 * x) * v[6]);
    if constexpr (kDeg > 2) {
      gx = gx + (((((((float(6.0 * D30) * xy) * v[8] + (C31 * yz) * v[9]) -
                    (float(2.0 * D32) * xy) * v[10]) -
                   (float(6.0 * D33) * xz) * v[11]) +
                  (C34 * ((4.f * zz - 3.f * xx) - yy)) * v[12]) +
                 (float(2.0 * D35) * xz) * v[13]) +
                (float(3.0 * D36) * (xx - yy)) * v[14]);
      gy = gy + (((((((float(3.0 * D30) * (xx - yy)) * v[8] +
                     (C31 * xz) * v[9]) +
                    (C32 * ((4.f * zz - xx) - 3.f * yy)) * v[10]) -
                   (float(6.0 * D33) * yz) * v[11]) -
                  (float(2.0 * D34) * xy) * v[12]) -
                 (float(2.0 * D35) * yz) * v[13]) -
                (float(6.0 * D36) * xy) * v[14]);
      gz = gz + (((((C31 * xy) * v[9] + (float(8.0 * D32) * yz) * v[10]) +
                   (float(3.0 * D33) * ((2.f * zz - xx) - yy)) * v[11]) +
                  (float(8.0 * D34) * xz) * v[12]) +
                 (C35 * (xx - yy)) * v[13]);
    }
  }
}

// The tile's blocks in shared memory: rest [kTile][3 rows], dc and means
// [kTile][3] each; the outputs overwrite them.
struct Tile {
  float* rest;
  float* dc;
  float* mean;
  long long base;
  int count;
};

__device__ __forceinline__ Tile tile_of(float* smem, int n, int rf) {
  Tile t;
  t.rest = smem;
  t.dc = smem + kTile * rf;
  t.mean = t.dc + kTile * 3;
  t.base = static_cast<long long>(blockIdx.x) * kTile;
  t.count = static_cast<int>(min(static_cast<long long>(kTile), n - t.base));
  return t;
}

template <int kDeg>
__device__ __forceinline__ void stage_inputs(const Tile& t,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ rest,
                                             const float* __restrict__ means,
                                             int rf) {
  stage_in(t.dc, dc + t.base * 3, t.count * 3);
  if constexpr (kDeg > 0) {     // degree 0: no direction, no rest
    stage_in(t.rest, rest + t.base * rf, t.count * rf);
    stage_in(t.mean, means + t.base * 3, t.count * 3);
  }
  __pipeline_commit();
}

template <int kDeg>
__global__ void __launch_bounds__(kTile) sh_fwd_kernel(
    const float* __restrict__ dc, const float* __restrict__ rest,
    const float* __restrict__ means, const float* __restrict__ campos, int n,
    int rows, float* __restrict__ rgb) {
  extern __shared__ __align__(16) float smem[];
  const int rf = 3 * rows;
  const Tile t = tile_of(smem, n, rf);
  stage_inputs<kDeg>(t, dc, rest, means, rf);
  __pipeline_wait_prior(0);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < t.count) {
    float b[basis_size(kDeg)];
    if constexpr (kDeg > 0) {
      sh_basis<kDeg>(direction(t.mean + 3 * i, campos), b);
    } else {
      b[0] = C0;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = colour<kDeg>(b, t.dc[3 * i + c], t.rest + rf * i + c);
      t.mean[3 * i + c] = v < 0.f ? 0.f : v;   // clamp_min keeps a NaN
    }
  }
  __syncthreads();
  stage_out(rgb + t.base * 3, t.mean, t.count * 3);
}

template <int kDeg>
__global__ void __launch_bounds__(kTile) sh_bwd_kernel(
    const float* __restrict__ g, int g_row, int g_col,
    const float* __restrict__ dc, const float* __restrict__ rest,
    const float* __restrict__ means, const float* __restrict__ campos, int n,
    int rows, float* __restrict__ g_dc, float* __restrict__ g_rest,
    float* __restrict__ g_means) {
  constexpr int kB = basis_size(kDeg);
  extern __shared__ __align__(16) float smem[];
  const int rf = 3 * rows;
  const Tile t = tile_of(smem, n, rf);
  stage_inputs<kDeg>(t, dc, rest, means, rf);
  const int i = threadIdx.x;
  float gin[3] = {0.f, 0.f, 0.f};
  if (i < t.count) {
    const float* gi = g + (t.base + i) * g_row;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      gin[c] = gi[static_cast<long long>(c) * g_col];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (i < t.count) {
    float b[kB];
    Direction u{};
    if constexpr (kDeg > 0) {
      u = direction(t.mean + 3 * i, campos);
      sh_basis<kDeg>(u, b);
    } else {
      b[0] = C0;
    }
    float* r = t.rest + rf * i;
    float gp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = colour<kDeg>(b, t.dc[3 * i + c], r + c);
      gp[c] = v > 0.f ? gin[c] : (v == 0.f ? 0.5f * gin[c] : 0.f);
    }
    if constexpr (kDeg > 0) {
      if (g_means != nullptr) {
        float vk[kB - 1];
#pragma unroll
        for (int k = 0; k < kB - 1; ++k)
          vk[k] = (r[3 * k] * gp[0] + r[3 * k + 2] * gp[2]) +
                  r[3 * k + 1] * gp[1];
        float gd[3];
        basis_grad<kDeg>(u, vk, gd[0], gd[1], gd[2]);
        const float s = (gd[0] * u.x + gd[2] * u.z) + gd[1] * u.y;
        const float along = u.n2 > kMinNorm2
                                ? s
                                : (u.n2 == kMinNorm2 ? 0.5f * s : 0.f);
        const float dir[3] = {u.x, u.y, u.z};
#pragma unroll
        for (int c = 0; c < 3; ++c)
          t.mean[3 * i + c] = u.inv * (gd[c] - dir[c] * along);
      }
    }
    if (g_dc != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) t.dc[3 * i + c] = b[0] * gp[c];
    }
    if (g_rest != nullptr) {
#pragma unroll
      for (int k = 0; k < kB - 1; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) r[3 * k + c] = b[k + 1] * gp[c];
      }
      for (int e = 3 * (kB - 1); e < rf; ++e) r[e] = 0.f;
    }
  }
  __syncthreads();
  if (g_dc != nullptr) stage_out(g_dc + t.base * 3, t.dc, t.count * 3);
  if (kDeg > 0 && g_means != nullptr)
    stage_out(g_means + t.base * 3, t.mean, t.count * 3);
  if (g_rest != nullptr)
    stage_out(g_rest + t.base * rf, t.rest, t.count * rf);
}

bool valid(int n, int deg, int rows) {
  return n >= 0 && deg >= 0 && deg <= 3 && rows <= kMaxRows &&
         rows >= basis_size(deg) - 1;
}

}  // namespace

// features_dc [n, 1, 3], features_rest [n, rows, 3] and means [n, 3]
// contiguous, campos [3], rgb [n, 3]: the clamped colour at degree deg.
GIGS_API int gigs_sh_fwd(int device, const void* dc, const void* rest,
                         const void* means, const void* campos, int n,
                         int deg, int rows, void* rgb, void* stream) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(n, deg, rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<blocks, kTile, smem_bytes(rows), s>>>(
        static_cast<const float*>(dc), static_cast<const float*>(rest),
        static_cast<const float*>(means), static_cast<const float*>(campos),
        n, rows, static_cast<float*>(rgb));
  };
  switch (deg) {
    case 0: args(sh_fwd_kernel<0>); break;
    case 1: args(sh_fwd_kernel<1>); break;
    case 2: args(sh_fwd_kernel<2>); break;
    default: args(sh_fwd_kernel<3>); break;
  }
  GIGS_RETURN_LAUNCH_STATUS();
}

// g [n, 3] at element strides (g_row, g_col); g_dc, g_rest and g_means are
// laid out as their inputs, and each may be null (not wanted; g_means is
// not written at degree 0, where the colour has no direction).
GIGS_API int gigs_sh_bwd(int device, const void* g, int g_row, int g_col,
                         const void* dc, const void* rest, const void* means,
                         const void* campos, int n, int deg, int rows,
                         void* g_dc, void* g_rest, void* g_means,
                         void* stream) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(n, deg, rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<blocks, kTile, smem_bytes(rows), s>>>(
        static_cast<const float*>(g), g_row, g_col,
        static_cast<const float*>(dc), static_cast<const float*>(rest),
        static_cast<const float*>(means), static_cast<const float*>(campos),
        n, rows, static_cast<float*>(g_dc), static_cast<float*>(g_rest),
        static_cast<float*>(g_means));
  };
  switch (deg) {
    case 0: args(sh_bwd_kernel<0>); break;
    case 1: args(sh_bwd_kernel<1>); break;
    case 2: args(sh_bwd_kernel<2>); break;
    default: args(sh_bwd_kernel<3>); break;
  }
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM of the forward
// (backward = 0) or backward kernel at degree 3 with `rows` rest rows
// (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_sh_resources(int device, int backward, int rows, int* out) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(0, 3, rows)) return static_cast<int>(cudaErrorInvalidValue);
  return backward ? gigs_kernel_resources(sh_bwd_kernel<3>, kTile,
                                          smem_bytes(rows), out)
                  : gigs_kernel_resources(sh_fwd_kernel<3>, kTile,
                                          smem_bytes(rows), out);
}
