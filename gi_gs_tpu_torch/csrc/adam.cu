// Adam over every parameter group of one optimizer (train/optim.GroupAdam
// on CUDA tensors): one launch per step, whatever the number of groups.
//
// Replaces: no Pallas kernel. JAX's update is optax's scale_by_adam and
//   the groups' rates (gi_gs_tpu/train/optim.py), which XLA fuses. As
//   PyTorch ops on the card (optim.adam_step, which CPU tensors keep) each
//   group was 15 one-op passes over the group: ~136 B of traffic a
//   trained float, 26.7 ms of a bicycle.train_p2 step (8.39 M slots x 67
//   floats, 562 M floats).
// Computes, per element, the chain's operations in the chain's order and
//   rounding on the card (the intrinsics round each product, sum,
//   quotient and root alone, as PyTorch's one-op kernels do):
//     mu' = c1 g + b1 mu,   nu' = c2 (g g) + b2 nu,
//     u   = (mu' * r1) / (sqrt(nu' * r2) + eps),   p' = p + (-(lr u)),
//   c1 = f32(1 - B1), b1 = f32(B1), c2, b2, eps likewise (a Python float
//   scalar is rounded to f32 once), lr the group's f32 rate, and r1, r2
//   the f32 reciprocals of the f32 bias corrections: PyTorch's true
//   division of a CUDA tensor by a CPU scalar multiplies by 1.0f / b
//   (div_true_kernel_cuda). The host computes lr, r1 and r2
//   (optim.adam_scalars); no value is read back from the device.
// Bound on the H100: bytes. Each element reads p, g, mu, nu and writes p',
//   mu', nu': 28 B, 15.7 GB over bicycle's 562 M floats, 4.7 ms at
//   3.35 TB/s. The arithmetic (~10 flops an element) would take 0.08 ms.
// Design: the groups travel in the launch's parameters (a
//   __grid_constant__ table of up to kMaxGroups entries: seven pointers,
//   the size, the three scalars). Each CTA takes one chunk of kChunk
//   consecutive elements of one group, found from the prefix of the
//   groups' chunk counts. A thread issues all of its loads (kUnroll
//   16-byte loads from each of the four inputs) before it computes, so a
//   SM keeps enough bytes in flight, and loads and stores with streaming
//   hints: the pass is ~300x the 50 MB L2 and nothing is read twice. A
//   group whose seven pointers are not all on 16 bytes takes scalar
//   accesses; a group's last elements past a multiple of 4 too. Out of
//   place: p', mu', nu' are new buffers, as the chain's results are.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // float4s a thread per array
constexpr int kChunk = kThreads * kUnroll * 4;   // elements a CTA
constexpr int kMaxGroups = 16;

struct Group {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  float* p_out;
  float* mu_out;
  float* nu_out;
  long long n;
  float lr, r1, r2;
  int vec;          // all seven pointers on 16 bytes
};

struct Table {
  Group group[kMaxGroups];
  long long first[kMaxGroups + 1];   // first chunk of each group; the grid
  int groups;
  float c1, b1, c2, b2, eps;
};

struct Out {
  float p, mu, nu;
};

__device__ __forceinline__ Out update(const Table& t, const Group& gr,
                                      float p, float g, float mu, float nu) {
  Out o;
  o.mu = __fadd_rn(__fmul_rn(t.c1, g), __fmul_rn(t.b1, mu));
  o.nu = __fadd_rn(__fmul_rn(t.c2, __fmul_rn(g, g)), __fmul_rn(t.b2, nu));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(o.nu, gr.r2)), t.eps);
  const float u = __fdiv_rn(__fmul_rn(o.mu, gr.r1), den);
  o.p = __fadd_rn(p, -__fmul_rn(gr.lr, u));
  return o;
}

__device__ __forceinline__ void update_one(const Table& t, const Group& gr,
                                           long long i) {
  const Out o = update(t, gr, __ldcs(gr.p + i), __ldcs(gr.g + i),
                       __ldcs(gr.mu + i), __ldcs(gr.nu + i));
  __stcs(gr.p_out + i, o.p);
  __stcs(gr.mu_out + i, o.mu);
  __stcs(gr.nu_out + i, o.nu);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table t) {
  const long long chunk = blockIdx.x;
  int k = 0;
  while (k + 1 < t.groups && chunk >= t.first[k + 1]) ++k;
  const Group& gr = t.group[k];
  const long long base = (chunk - t.first[k]) * kChunk;
  const long long n = gr.n;
  if (!gr.vec) {
#pragma unroll
    for (int j = 0; j < kUnroll * 4; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      if (i < n) update_one(t, gr, i);
    }
    return;
  }
  long long at[kUnroll];
  float4 p[kUnroll], g[kUnroll], mu[kUnroll], nu[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    at[u] = base + 4ll * (u * kThreads + threadIdx.x);
    if (at[u] + 4 <= n) {
      p[u] = __ldcs(reinterpret_cast<const float4*>(gr.p + at[u]));
      g[u] = __ldcs(reinterpret_cast<const float4*>(gr.g + at[u]));
      mu[u] = __ldcs(reinterpret_cast<const float4*>(gr.mu + at[u]));
      nu[u] = __ldcs(reinterpret_cast<const float4*>(gr.nu + at[u]));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (at[u] + 4 <= n) {
      const Out x = update(t, gr, p[u].x, g[u].x, mu[u].x, nu[u].x);
      const Out y = update(t, gr, p[u].y, g[u].y, mu[u].y, nu[u].y);
      const Out z = update(t, gr, p[u].z, g[u].z, mu[u].z, nu[u].z);
      const Out w = update(t, gr, p[u].w, g[u].w, mu[u].w, nu[u].w);
      __stcs(reinterpret_cast<float4*>(gr.p_out + at[u]),
             make_float4(x.p, y.p, z.p, w.p));
      __stcs(reinterpret_cast<float4*>(gr.mu_out + at[u]),
             make_float4(x.mu, y.mu, z.mu, w.mu));
      __stcs(reinterpret_cast<float4*>(gr.nu_out + at[u]),
             make_float4(x.nu, y.nu, z.nu, w.nu));
    } else {
      for (long long i = at[u]; i < n; ++i) update_one(t, gr, i);
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// ptrs: host int64 [groups, 8], per group p, g, mu, nu, p_out, mu_out,
// nu_out (contiguous f32 on `device`) and the element count; scalars: host
// f32 [groups, 3], per group lr, r1, r2; c1, b1, c2, b2, eps: the chain's
// f32 constants. One launch for every group.
GIGS_API int gigs_adam(int device, const void* ptrs, const void* scalars,
                       int groups, float c1, float b1, float c2, float b2,
                       float eps, void* stream) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 0 || groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pp = static_cast<const long long*>(ptrs);
  const auto* sc = static_cast<const float*>(scalars);
  Table t{};
  t.groups = groups;
  t.c1 = c1;
  t.b1 = b1;
  t.c2 = c2;
  t.b2 = b2;
  t.eps = eps;
  long long chunks = 0;
  for (int k = 0; k < groups; ++k) {
    const long long* r = pp + 8 * k;
    Group& gr = t.group[k];
    gr.p = reinterpret_cast<const float*>(r[0]);
    gr.g = reinterpret_cast<const float*>(r[1]);
    gr.mu = reinterpret_cast<const float*>(r[2]);
    gr.nu = reinterpret_cast<const float*>(r[3]);
    gr.p_out = reinterpret_cast<float*>(r[4]);
    gr.mu_out = reinterpret_cast<float*>(r[5]);
    gr.nu_out = reinterpret_cast<float*>(r[6]);
    gr.n = r[7];
    if (gr.n < 0) return static_cast<int>(cudaErrorInvalidValue);
    gr.lr = sc[3 * k];
    gr.r1 = sc[3 * k + 1];
    gr.r2 = sc[3 * k + 2];
    gr.vec = aligned(gr.p) && aligned(gr.g) && aligned(gr.mu) &&
             aligned(gr.nu) && aligned(gr.p_out) && aligned(gr.mu_out) &&
             aligned(gr.nu_out);
    t.first[k] = chunks;
    chunks += (gr.n + kChunk - 1) / kChunk;
  }
  t.first[groups] = chunks;
  if (chunks == 0) return 0;
  if (chunks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  GIGS_RETURN_LAUNCH_STATUS();
}

GIGS_API int gigs_adam_resources(int device, int* out) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return gigs_kernel_resources(adam_kernel, kThreads, 0, out);
}
