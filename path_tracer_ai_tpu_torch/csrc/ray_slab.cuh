// One ray's inclusive slab test against a box, in the two forms the port
// keeps bit for bit, shared by the per-ray culls (ray_cull.cu: kslots_cull,
// perray_cull, the pair tables' cull) and ctiles' 2-level cull
// (ctiles_cull.cu), and by the exact shadow cull (packet_cull.cu), so that
// their copies cannot drift.
//
//   kslots (path_tracer_ai_tpu/accel/kslots.py:81-107): inv = 1 / d (IEEE
//     division); per axis t0 = (lo - o) inv, t1 = (hi - o) inv, near =
//     min(t0, t1) and far = max(t0, t1), where a NaN in t0 or t1 (torch's
//     and jnp's min / max carry it) makes (near, far) = (-inf, +inf); then
//     lo = max(max near, lo0), hi = min(min far, hi0); candidate: hi >= lo.
//     An inverted box (the padding children of a partly filled last
//     super, "phantoms") passes for every live ray: its t0 and t1 swap.
//   perray (path_tracer_ai_tpu/accel/traverse.py:548-566, pairs.py:61-78,
//     ctiles.py:266-294 for the children): the comparison-select form.
//     neg = inv < 0 (a -0.0 direction gives -inf, negative); near = neg ?
//     t1 : t0, far = neg ? t0 : t1; lo starts at lo0, hi at hi0 (a NaN
//     hi0 stays NaN, as torch.minimum(t_max, inf) keeps it); per axis lo =
//     near > lo ? near : lo, hi = far < hi ? far : hi, so a NaN near or far
//     keeps the running bound; candidate: hi >= lo. An inverted box fails.
//   the exact shadow cull (path_tracer_ai_tpu/accel/traverse.py:205-397,
//     slab_lanes): the sign-select form, which gives perray's bits
//     (perray_slab below says why).
// Signed zeros reach only lo and hi, whose zeros compare equal. In both
// rules lo only grows and hi only shrinks from (lo0, hi0), so a ray whose
// window fails hi0 >= lo0 has no candidate and needs no test.
//
// The kernels build with --fmad=false and no fast math: (lo - o) * inv is
// never contracted, and 1 / d is the IEEE quotient.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

// A ray as the tests read it: origin, 1 / d and its window [lo0, hi0].
// Eight floats, the layout the block culls stage in shared memory.
struct RayIn {
  float o[3], inv[3], lo0, hi0;
};

// One ray's origin, 1 / d (IEEE) and its window, read by every lane.
__device__ __forceinline__ RayIn load_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          size_t ray, float lo0, float hi0) {
  RayIn r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = __ldg(o + 3 * ray + a);
    r.inv[a] = __fdiv_rn(1.0f, __ldg(d + 3 * ray + a));
  }
  r.lo0 = lo0;
  r.hi0 = hi0;
  return r;
}

// A box's three coordinates (bmin or bmax of one box) into registers.
__device__ __forceinline__ void load_box(const float* __restrict__ p,
                                         float v[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) v[a] = __ldg(p + a);
}

// kslots' slab rule (above) against the box (lo, hi).
__device__ __forceinline__ bool kslots_slab(const RayIn& r, const float lo[3],
                                            const float hi[3]) {
  float nmax = -INFINITY, fmin = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - r.o[a]) * r.inv[a];
    const float t1 = (hi[a] - r.o[a]) * r.inv[a];
    const bool nan = t0 != t0 || t1 != t1;
    nmax = fmaxf(nmax, nan ? -INFINITY : fminf(t0, t1));
    fmin = fminf(fmin, nan ? INFINITY : fmaxf(t0, t1));
  }
  // lo0 and hi0 are not NaN here (the callers' windows are not)
  return fminf(fmin, r.hi0) >= fmaxf(nmax, r.lo0);
}

// perray's comparison-select slab rule (above) against the box (lo, hi);
// *entry = the window's start lo (perray's entry t in order_mode "entry").
__device__ __forceinline__ bool perray_window(const RayIn& r,
                                              const float lo[3],
                                              const float hi[3],
                                              float* entry) {
  float lo_t = r.lo0, hi_t = r.hi0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - r.o[a]) * r.inv[a];
    const float t1 = (hi[a] - r.o[a]) * r.inv[a];
    const bool neg = r.inv[a] < 0.0f;
    const float near = neg ? t1 : t0;
    const float far = neg ? t0 : t1;
    lo_t = near > lo_t ? near : lo_t;
    hi_t = far < hi_t ? far : hi_t;
  }
  *entry = lo_t;
  return hi_t >= lo_t;
}

// perray's rule, the test alone. It is also the exact shadow cull's
// (packet_cull.cu exact_cull; accel/cuda_cull.py `_slab_lanes`, the
// sign-select form with pos = inv >= 0 and a NaN near / far guarded to
// -inf / +inf): for a lane whose window (lo0 = t_min, hi0 = t_max or -inf)
// holds no NaN the two rules keep the same bounds, as a guarded NaN and a
// NaN that fails the comparison both leave the running bound, and pos is
// !neg wherever inv is not NaN (a NaN inv makes near and far NaN in both).
__device__ __forceinline__ bool perray_slab(const RayIn& r, const float lo[3],
                                            const float hi[3]) {
  float entry;
  return perray_window(r, lo, hi, &entry);
}

// Writes the passing ids of one chunk (hit, id per lane) to row[count..],
// in lane order, the first k of the row only; returns the chunk's count.
__device__ __forceinline__ int put_ids(int* row, int k, bool hit, int id,
                                       int lane, int count) {
  const unsigned m = __ballot_sync(FULL_MASK, hit);
  const int pos = count + __popc(m & ((1u << lane) - 1u));
  if (hit && pos < k) row[pos] = id;
  return __popc(m);
}
