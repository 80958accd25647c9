// Locally connected halo filter of the GGX prefilter:
//   out[f, c, y, x] = sum_{dy, dx} W[f, dy * P + dx, y, x] * pad[f, c, y + dy, x + dx]
//
// Replaces: gi_gs_tpu/ops/pallas_patch.py:patch_apply_fwd (_fwd_kernel,
//   pallas_patch.py:39-58).
//   W [6, P^2, R, R] is the static weight table of cubemap._patch_tables;
//   pad [6, 3, E, E] the halo-padded faces (E = R + 2h, P = 2h + 1).
//
// Bound on the H100: bytes. W is read once (6 P^2 R^2 floats: 354 MB at
//   R = 256, P = 15; 661 MB at R = 128, P = 41; 319 MB at R = 64, P = 57)
//   against 6 flops per weight.
// Summation order: for each output texel, the offsets in order
//   p = dy * P + dx = 0 .. P^2 - 1 (dy outer, dx inner), each product
//   pad * W added to one running f32 sum that starts at +0, as
//   `_patch_fwd_plain` adds them (-fmad=false): bit-equal to it.
// Design: a CTA owns one output row y of one face, one consumer thread
//   per output texel (its three channels), and one producer warp, so the
//   W bytes in flight are the ring's, not the consumers' loads: a tile of
//   texels per CTA staging its padded window (66 KB at R = 64) leaves one
//   CTA and a few 128-byte loads in flight per SM.
//   - A ring of `stages` stages with full / empty mbarriers; stage dy
//     holds row y of the P weight planes (dy, 0 .. P - 1) and padded row
//     y + dy of the three channels.
//   - The P rows of one stage's W are one TMA box {R, 1, P} of the tensor
//     map W [6 P^2, R, R]: one instruction copies 14.6 KB at R = 64, where
//     one bulk copy per 256-byte row (as patch_bwd.cu copies) is slower.
//   - A padded row is one bulk copy per channel, from its start rounded
//     down to 16 bytes (E = 270 puts every other row on 8 bytes), read at
//     that shift.
//   - 384 CTAs at R = 64, 768 at 128, 1536 at 256, with the ring sized
//     for three CTAs per SM (cubemap.patch_fwd_shape).
//   - Per weight: one shared load of W, three of pad, 3 FMUL and 3 FADD;
//     W and pad both read by consecutive lanes at consecutive addresses.
#include "common.cuh"

#include <cuda.h>

namespace {

constexpr int kMaxR = 256;                        // a TMA box side
constexpr int kMaxThreads = kMaxR + 32;
constexpr int kMaxSmem = 232448;                  // the H100's opt-in limit

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once per process through the runtime
// (null if it is missing).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of W as [6 P^2][R][R] f32, read in boxes of one row of
// P planes.
cudaError_t weight_map(CUtensorMap* map, const void* W, int R, int P) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(6) * P * P};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(R) * 4,
                                 static_cast<cuuint64_t>(R) * R * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(R), 1,
                             static_cast<cuuint32_t>(P)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(W), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One TMA box of a 3-D tensor map into shared memory (128-byte aligned
// destination); its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(gigs_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(gigs_smem_addr(bar))
      : "memory");
}

// The ring of one level, in floats where not said; the same arithmetic
// as cubemap.patch_fwd_shape, which chooses the stages.
struct Shape {
  int slot;   // one channel's padded row, a shift of up to 3, rounding
  int stage;  // P weight rows then 3 slots, rounded up to 128 bytes
  int smem;   // bytes: the ring, then full[stages] and empty[stages]
};

Shape shape_of(int R, int P, int stages) {
  Shape c;
  c.slot = (R + P - 1 + 6) & ~3;
  c.stage = (P * R + 3 * c.slot + 31) & ~31;
  c.smem = stages * c.stage * 4 + 2 * stages * 8;
  return c;
}

__global__ void __launch_bounds__(kMaxThreads) patch_fwd_kernel(
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ pad,
    float* __restrict__ out, int R, int P, int stages, int stage, int slot) {
  extern __shared__ __align__(128) float ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage);
  uint64_t* empty = full + stages;

  const int f = blockIdx.z;
  const int y = blockIdx.y;
  const int E = R + P - 1;
  const int nw = (R + 31) / 32;       // consumer warps
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      gigs_mbar_init(&full[s], 1);
      gigs_mbar_init(&empty[s], nw);
    }
    gigs_mbar_fence_init();
  }
  __syncthreads();

  if (warp == nw) {
    // Producer: lane 0 copies the W box of stage dy, lanes 1-3 the padded
    // row of channels 0-2. Channel c's row starts at float
    // ((3 f + c) E + y + dy) E; E is even, so E^2 is a multiple of 4 and
    // the shift past 16 bytes, ((y + dy) E) & 3, is every channel's.
    const uint32_t wbytes = 4u * P * R;
    for (int dy = 0; dy < P; ++dy) {
      const int s = dy % stages;
      if (dy >= stages) gigs_mbar_wait(&empty[s], (dy / stages - 1) & 1);
      const int start = (3 * f * E + y + dy) * E;
      const int a = start & 3;
      const uint32_t pbytes = 4u * ((a + E + 3) & ~3);
      if (lane == 0)
        gigs_mbar_arrive_expect_tx(&full[s], wbytes + 3 * pbytes);
      __syncwarp();
      float* st = ring + s * stage;
      if (lane == 0) {
        tma_load_3d(st, &wmap, 0, y, (f * P + dy) * P, &full[s]);
      } else if (lane <= 3) {
        const int c = lane - 1;
        gigs_bulk_load(st + P * R + c * slot, pad + start - a + c * E * E,
                       pbytes, &full[s]);
      }
    }
    return;
  }

  // Consumers: thread x owns texel (y, x). Stage dy holds its weight of
  // offset (dy, dx) at dx R + x and channel c's padded value (y + dy,
  // x + dx) at P R + c slot + a + x + dx. Threads past the last column (R
  // not a multiple of 32) repeat it and store nothing.
  const int x = min(static_cast<int>(threadIdx.x), R - 1);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int dy = 0; dy < P; ++dy) {
    const int s = dy % stages;
    gigs_mbar_wait(&full[s], (dy / stages) & 1);
    const float* wp = ring + s * stage + x;
    const float* pp = ring + s * stage + P * R + (((y + dy) * E) & 3) + x;
#pragma unroll 8
    for (int dx = 0; dx < P; ++dx) {
      const float wv = wp[dx * R];
      a0 += pp[dx] * wv;
      a1 += pp[slot + dx] * wv;
      a2 += pp[2 * slot + dx] * wv;
    }
    __syncwarp();
    if (lane == 0) gigs_mbar_arrive(&empty[s]);
  }

  if (static_cast<int>(threadIdx.x) < R) {
    float* o = out + (3 * f * R + y) * R + x;
    o[0] = a0;
    o[R * R] = a1;
    o[2 * R * R] = a2;
  }
}

cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_opt_in_smem(device, done, patch_fwd_kernel);
}

bool valid(int R, int P, int stages, const Shape& c) {
  return R % 4 == 0 && R <= kMaxR && P >= 1 && P <= 256 && stages >= 1 &&
         c.smem <= kMaxSmem;
}

}  // namespace

// R must be a multiple of 4 (W rows and padded rows are copied in 16-byte
// units) and at most 256 (a TMA box side), W and pad 16-byte aligned.
// `stages`, the ring's depth, is the level's from cubemap.patch_fwd_shape;
// a ring that passes the card's shared memory is refused.
GIGS_API int gigs_patch_fwd(int device, const void* W, const void* pad,
                            void* out, int R, int P, int h, int stages,
                            void* stream) {
  (void)h;  // P = 2h + 1
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape c = shape_of(R, P, stages);
  if (!valid(R, P, stages, c)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap;
  err = weight_map(&wmap, W, R, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(1, R, 6);
  const int threads = 32 * ((R + 31) / 32 + 1);
  patch_fwd_kernel<<<grid, threads, c.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const float*>(pad), static_cast<float*>(out), R, P,
      stages, c.stage, c.slot);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM at a level's launch
// shape (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_patch_fwd_resources(int device, int R, int P, int stages,
                                      int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape c = shape_of(R, P, stages);
  if (!valid(R, P, stages, c)) return static_cast<int>(cudaErrorInvalidValue);
  return gigs_kernel_resources(patch_fwd_kernel, 32 * ((R + 31) / 32 + 1),
                               c.smem, out);
}
