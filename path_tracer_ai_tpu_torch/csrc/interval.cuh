// The conservative interval slab test of a ray block against a box, shared
// by the packet cascades' cull (packet_cull.cu) and the worklist's
// (worklist_cull.cu), so that their op-for-op copies of
// accel/traverse.py `_ray_block_bounds` and `_interval_slab` cannot drift.
//
// 1. The block's bounds over its live lanes (t_max >= 0): olo, ohi, dlo,
//    dhi per axis, and tmax_ub = the max t_max over all its lanes. An
//    all-dead block gives (+inf, -inf), as a reduction over nothing.
//    torch.minimum / maximum (and jnp's) carry a NaN, fminf / fmaxf drop
//    it: the reductions carry a NaN flag beside each value (bit i of
//    `nan_bits` for value i), put back as a NaN by bounds_put_nan.
// 2. Per box, _interval_slab: per axis nlo = bmin - ohi, nhi = bmax - olo,
//    the four quotients by the guarded bounds (|d| > 0 ? d : 1) in IEEE
//    division (__fdiv_rn; the port builds with --fmad=false and no fast
//    math), their min and max; (-inf, +inf) where the direction interval
//    spans 0 (dlo <= 0 <= dhi, so -0.0 counts as 0); lb = max over the
//    axes, ub = min. cand = lb <= ub & ub >= 0 & lb <= tmax_ub. A NaN
//    quotient makes the plain version's lb or ub NaN and its cand false:
//    here it is flagged, and the min and max of the other values are
//    fminf / fmaxf. An axis that spans 0 is skipped: its (-inf, +inf)
//    leaves lb and ub as they are. Signed zeros reach only lb and ub,
//    whose zeros compare equal. An inverted box (min > max, the 2-level
//    cull's padding children) is not failed: its numerator interval is
//    reversed, so each axis gives (-huge, +huge), as in the reference.
//
// Values of the bounds array v[BOUNDS_N]: v[0..2] olo, v[3..5] dlo (min);
// v[6..8] ohi, v[9..11] dhi, v[12] tmax_ub (max).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif
#define BOUNDS_N 13
#define BOUNDS_MINS 6  // v[0 .. BOUNDS_MINS) are minima, the rest maxima

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void bounds_init(float* v, unsigned* nan_bits) {
#pragma unroll
  for (int i = 0; i < BOUNDS_MINS; ++i) v[i] = INFINITY;
#pragma unroll
  for (int i = BOUNDS_MINS; i < BOUNDS_N; ++i) v[i] = -INFINITY;
  *nan_bits = 0u;
}

// Lane i of the ray block (o, d: its 3 floats; tm its t_max) into the
// bounds: a dead lane (tm < 0 or NaN) adds only its t_max.
__device__ __forceinline__ void bounds_add_lane(float* v, unsigned* nan_bits,
                                                const float* __restrict__ o,
                                                const float* __restrict__ d,
                                                float tm) {
  const bool live = tm >= 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float oa = live ? o[a] : INFINITY;
    const float da = live ? d[a] : INFINITY;
    *nan_bits |= (oa != oa ? 0x41u : 0u) << a | (da != da ? 0x41u : 0u)
                                                    << (3 + a);
    v[a] = fminf(v[a], oa);
    v[3 + a] = fminf(v[3 + a], da);
    v[6 + a] = fmaxf(v[6 + a], live ? oa : -INFINITY);
    v[9 + a] = fmaxf(v[9 + a], live ? da : -INFINITY);
  }
  *nan_bits |= (tm != tm ? 1u : 0u) << 12;
  v[12] = fmaxf(v[12], tm);
}

// The warp's bounds in every lane (NaN flags OR'd, not yet put back).
__device__ __forceinline__ void bounds_warp_reduce(float* v,
                                                   unsigned* nan_bits) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < BOUNDS_MINS; ++i)
      v[i] = fminf(v[i], __shfl_xor_sync(FULL_MASK, v[i], off));
#pragma unroll
    for (int i = BOUNDS_MINS; i < BOUNDS_N; ++i)
      v[i] = fmaxf(v[i], __shfl_xor_sync(FULL_MASK, v[i], off));
  }
  *nan_bits = __reduce_or_sync(FULL_MASK, *nan_bits);
}

__device__ __forceinline__ void bounds_put_nan(float* v, unsigned nan_bits) {
#pragma unroll
  for (int i = 0; i < BOUNDS_N; ++i)
    if (nan_bits >> i & 1u) v[i] = __int_as_float(0x7fc00000);
}

// A block's bounds as the interval test reads them.
struct SlabBlock {
  float olo[3], ohi[3], slo[3], shi[3];
  bool spans[3];
  float tmax_ub;
};

__device__ __forceinline__ SlabBlock slab_block(const float* v) {
  SlabBlock s;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.olo[a] = v[a];
    s.ohi[a] = v[6 + a];
    const float dlo = v[3 + a], dhi = v[9 + a];
    s.spans[a] = dlo <= 0.0f && dhi >= 0.0f;
    s.slo[a] = fabsf(dlo) > 0.0f ? dlo : 1.0f;
    s.shi[a] = fabsf(dhi) > 0.0f ? dhi : 1.0f;
  }
  s.tmax_ub = v[12];
  return s;
}

// Whether the box (lo, hi: its 3 floats each) is a candidate of the block
// (cand above); *lb_out = its lb where it is. A pair leaves at the first
// axis after which it cannot be a candidate (lb only grows, ub only
// shrinks, a NaN stays flagged).
__device__ __forceinline__ bool slab_candidate(const SlabBlock& s,
                                               const float* __restrict__ lo,
                                               const float* __restrict__ hi,
                                               float* lb_out) {
  float lb = -INFINITY, ub = INFINITY;
  bool nan = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (s.spans[a]) continue;
    const float nlo = __ldg(lo + a) - s.ohi[a];
    const float nhi = __ldg(hi + a) - s.olo[a];
    const float q1 = __fdiv_rn(nlo, s.slo[a]);
    const float q2 = __fdiv_rn(nlo, s.shi[a]);
    const float q3 = __fdiv_rn(nhi, s.slo[a]);
    const float q4 = __fdiv_rn(nhi, s.shi[a]);
    nan |= q1 != q1 || q2 != q2 || q3 != q3 || q4 != q4;
    lb = fmaxf(lb, fminf(fminf(q1, q2), fminf(q3, q4)));
    ub = fminf(ub, fmaxf(fmaxf(q1, q2), fmaxf(q3, q4)));
    if (nan || !(lb <= ub && ub >= 0.0f && lb <= s.tmax_ub)) break;
  }
  *lb_out = lb;
  return !nan && lb <= ub && ub >= 0.0f && lb <= s.tmax_ub;
}
