// Device code shared by the two screen-space marches (gi_march.cu, the
// exact march; gi_march_coherent.cu, the block-coherent one): the f32
// helpers whose rounding both marches and their plain PyTorch versions
// share, the projection of a marched point to a pixel, and the walk over
// one pixel's (direction, step) samples.
//
// Every helper repeats the plain version's f32 operations in its order
// (the sources build with -fmad=false, so nothing is contracted): one ulp
// moves a sample to the next pixel or flips a depth test, and one flipped
// ray moves a pixel's occlusion by a direction weight (<= 0.0031).
#pragma once

#include <math.h>

#include "common.cuh"

namespace gigs_march {

// torch.clamp(x, min=1e-20) of unit3's norm, NaN passing through as in
// torch.
__device__ __forceinline__ float clamp_norm(float n) {
  return n < 1e-20f ? 1e-20f : n;
}

// v / max(|v|, 1e-20), |v| = sqrt((x*x + y*y) + z*z) (screen_space._unit3)
__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float n = clamp_norm(sqrtf(x * x + y * y + z * z));
  x = x / n;
  y = y / n;
  z = z / n;
}

__device__ __forceinline__ float round_half_away(float x) {
  return truncf(x + (x >= 0.0f ? 0.5f : -0.5f));
}

// (int)round_half_away(x) in one conversion (F2I.TRUNC, no FRND): the same
// integer wherever it is one; past the int range it saturates, still out of
// any image, and NaN gives 0 as (int)NaN does.
__device__ __forceinline__ int round_half_away_int(float x) {
  return __float2int_rz(x + (x >= 0.0f ? 0.5f : -0.5f));
}

// The Gram-Schmidt TBN of a unit normal n from up = (0, 1, 0)
// (forward.cu:661-675, screen_space._tbn): t = unit3(up - n * n.y),
// b = unit3(n x t). A normal at +-up or of length 0 gives t = b = 0.
struct Tbn {
  float tx, ty, tz, bx, by, bz, nx, ny, nz;
};

__device__ __forceinline__ Tbn make_tbn(float nx, float ny, float nz) {
  unit3(nx, ny, nz);
  Tbn f;
  f.nx = nx;
  f.ny = ny;
  f.nz = nz;
  f.tx = -nx * ny;
  f.ty = 1.0f - ny * ny;
  f.tz = -nz * ny;
  unit3(f.tx, f.ty, f.tz);
  f.bx = ny * f.tz - nz * f.ty;
  f.by = nz * f.tx - nx * f.tz;
  f.bz = nx * f.ty - ny * f.tx;
  unit3(f.bx, f.by, f.bz);
  return f;
}

// The direction (dx, dy, dz) rotated into the TBN:
// (dx * t + dy * b) + dz * n.
__device__ __forceinline__ float3 rotate(const Tbn& f, float4 d) {
  return make_float3(d.x * f.tx + d.y * f.bx + d.z * f.nx,
                     d.x * f.ty + d.y * f.by + d.z * f.ny,
                     d.x * f.tz + d.y * f.bz + d.z * f.nz);
}

// The point p + v * s, s = f32(j) * zsc, projected with +1e-7 on its
// depth: (x / z) * f + c, before rounding. Returns the marched depth.
__device__ __forceinline__ float project(float3 p, float3 v, float s, float fx,
                                         float fy, float cx, float cy,
                                         float& qx, float& qy) {
  const float spx = p.x + v.x * s;
  const float spy = p.y + v.y * s;
  const float spz = p.z + v.z * s;
  const float zz = spz + 1e-7f;
  qx = spx / zz * fx + cx;
  qy = spy / zz * fy + cy;
  return spz;
}

// Walks one pixel's samples in table order, lock-step: direction d = 0 ..
// nd - 1, and in each the steps jj = 0 .. ns - 1 until the ray ends.
// `m.dir(d)` sets up direction d; `m.sample(jj, fj)` takes step jj of it,
// fj = f32(start + jj) (kept as a float counter: exact below 2^24, and no
// int-to-float conversion per sample), and returns true where the ray ends
// (a hit, or a sample outside the image). The lanes of a warp stay on one
// (d, jj), so a lane whose ray has ended waits for the warp's longest ray
// (0.97 of issued lane-steps are live samples at 800x800, PERF.md), and the
// coherent march's z and RGB loads stay coalesced rows.
template <class March>
__device__ __forceinline__ void walk(March& m, int nd, int start, int ns) {
  const float fstart = static_cast<float>(start);
  for (int d = 0; d < nd; ++d) {
    m.dir(d);
    float fj = fstart;
    for (int jj = 0; jj < ns; ++jj, fj += 1.0f)
      if (m.sample(jj, fj)) break;
  }
}

}  // namespace gigs_march
