// The per-ray culls for Hopper (sm_90a): kslots_cull and perray_cull.
//
// Replace no Pallas kernel: they are XLA-fused bodies of the JAX package.
//   kslots_cull: the CULL + EXTRACT of path_tracer_ai_tpu/accel/kslots.py
//     `_chunk_pipeline` (kslots.py:110-163, with `_ray_slab` :81,
//     `_pack_bits` :44 and `_peel_k` :56), one ray's slab test against the
//     supercluster boxes, then against the children of its first k_supers
//     supers (levels 2), or against every cluster box (levels 1), and its
//     first k_clusters cluster ids in ascending order;
//   perray_cull: `_perray_candidates` in order_mode "id"
//     (path_tracer_ai_tpu/accel/traverse.py:530-603), one ray's slab test
//     against every cluster box and its first cap candidate ids ascending.
// JAX runs each as a lax.map over row chunks inside one executable; the
// port's plain versions (accel/cuda_cull.py kslots_cull_plain,
// perray_cull_plain) as chains of eager ops over [rows, boxes]
// temporaries.
//
// The two slab rules differ, and each is kept bit for bit:
//   kslots (kslots.py:81-107): inv = 1 / d (IEEE division); per axis
//     t0 = (lo - o) inv, t1 = (hi - o) inv, near = min(t0, t1) and
//     far = max(t0, t1), where a NaN in t0 or t1 (torch's and jnp's min /
//     max carry it) makes (near, far) = (-inf, +inf); then
//     lo = max(max near, t_min), hi = min(min far, t_max or -inf for a
//     dead ray); candidate: hi >= lo. An inverted box (the padding
//     children of a partly filled last super, "phantoms") passes for
//     every live ray: its t0 and t1 swap.
//   perray (traverse.py:548-566): the comparison-select form. neg =
//     inv < 0 (a -0.0 direction gives -inf, negative); near = neg ? t1 :
//     t0, far = neg ? t0 : t1; lo starts at t_min, hi at t_max (a NaN
//     t_max stays NaN, as torch.minimum(t_max, inf) keeps it); per axis
//     lo = near > lo ? near : lo, hi = far < hi ? far : hi, so a NaN near
//     or far keeps the running bound; candidate: hi >= lo.
// Signed zeros reach only lo and hi, whose zeros compare equal. In both
// rules lo only grows and hi only shrinks from (t_min, t_max), so a ray
// whose t_min and t_max fail hi >= lo has no candidate and tests nothing.
//
// Layouts (accel/cuda_cull.py): o, d [N, 3] f32, tm [N] f32 (t_max), all
// contiguous; boxes bmin, bmax [C, 3] (levels 1, perray) or the supers
// sbmin, sbmax [Cs, 3] and the children cbmin, cbmax [Cs, ss, 3] (levels
// 2).
//   kslots_cull: cid [N, k_clusters] i32 (the first ids ascending, each
//   clamped to C - 1; every slot past the count, and every slot of an
//   overflowing ray, holds the pad below); n_cand, n_slots [N] i32; over,
//   over_supers, over_clusters, phantom_only [N] u8.
//   perray_cull: order [N, cap] i32 (the first min(cap, C) candidate ids
//   ascending, also for an overflowing ray; C - 1 past the count up to
//   min(cap, C), 0 from C to cap); n_cand [N] i32 clipped to cap;
//   overflow [N] u8 (more than cap candidates).
//
// kslots at levels 2, per ray:
//   ns supers pass; over_s = ns > k_supers; the first k_supers of them
//   (ascending) are listed, and the scan stops once over_s is known. The
//   children of the listed supers, phantoms included, are tested in
//   ascending (super, child) order, which is ascending cluster id:
//   n_cand counts every one that passes, also for an over_s ray, and
//   n_real those below C. over = over_s | n_cand > k_clusters; n_slots =
//   over ? 0 : n_cand; over_clusters = over & !over_s; phantom_only =
//   over_clusters & n_real <= k_clusters. The pad is the reference's
//   cid_table[r, cols - 1] clamped: min(sup * ss + ss - 1, C - 1), sup the
//   ray's k_supers-th passing super where it has that many, Cs - 1
//   otherwise. At levels 1 every cluster box is tested, over_s and
//   phantom_only are false and the pad is C - 1.
//
// Design: one warp a ray, RC_WARPS warps a thread block sharing nothing
// (no block barrier). The lanes read the ray (one broadcast load) and
// stride the boxes 32 at a time; a ballot and a popc prefix place each
// chunk's passing ids in ascending order (worklist_cull.cu's append). At
// levels 2 the passing supers go to the warp's list in shared memory and
// their k_supers * ss children are swept flat, (super, child) pairs 32 at
// a time. perray stops at the chunk where its count passes cap.
//
// What bounds it: the box tests' operations (chip_smoke.py
// RCULL_AXIS_OPS a box and axis, RCULL_BOX_OPS a box; no division per
// box, one IEEE division per ray and axis), counted over the boxes this
// run's rays test, against the rays in and the tables out.

#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu
#define RC_WARPS 8  // warps (rays) a thread block
// the largest super list a warp keeps (min(k_supers, Cs) ints a warp, in
// RC_WARPS * RC_MAX_SUPERS * 4 bytes of shared memory at most)
#define RC_MAX_SUPERS 1536

struct RayIn {
  float o[3], inv[3], lo0, hi0;
};

// One ray's origin, 1 / d (IEEE) and its window, read by every lane.
__device__ __forceinline__ RayIn load_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          int ray, float lo0, float hi0) {
  RayIn r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = __ldg(o + 3 * (size_t)ray + a);
    r.inv[a] = __fdiv_rn(1.0f, __ldg(d + 3 * (size_t)ray + a));
  }
  r.lo0 = lo0;
  r.hi0 = hi0;
  return r;
}

// kslots' slab rule (above) against the box (lo, hi: 3 floats each).
__device__ __forceinline__ bool kslots_slab(const RayIn& r,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float nmax = -INFINITY, fmin = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (__ldg(lo + a) - r.o[a]) * r.inv[a];
    const float t1 = (__ldg(hi + a) - r.o[a]) * r.inv[a];
    const bool nan = t0 != t0 || t1 != t1;
    nmax = fmaxf(nmax, nan ? -INFINITY : fminf(t0, t1));
    fmin = fminf(fmin, nan ? INFINITY : fmaxf(t0, t1));
  }
  // lo0 and hi0 are not NaN here (the caller's hi0 >= lo0 held)
  return fminf(fmin, r.hi0) >= fmaxf(nmax, r.lo0);
}

// perray's comparison-select slab rule (above).
__device__ __forceinline__ bool perray_slab(const RayIn& r,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float lo_t = r.lo0, hi_t = r.hi0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (__ldg(lo + a) - r.o[a]) * r.inv[a];
    const float t1 = (__ldg(hi + a) - r.o[a]) * r.inv[a];
    const bool neg = r.inv[a] < 0.0f;
    const float near = neg ? t1 : t0;
    const float far = neg ? t0 : t1;
    lo_t = near > lo_t ? near : lo_t;
    hi_t = far < hi_t ? far : hi_t;
  }
  return hi_t >= lo_t;
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

struct KsArgs {
  const float* o;
  const float* d;
  const float* tm;
  const float* bmin;   // [C, 3] (levels 1) or [Cs, 3] supers (levels 2)
  const float* bmax;
  const float* cbmin;  // [Cs, ss, 3] children (levels 2)
  const float* cbmax;
  int* cid;
  int* n_cand;
  int* n_slots;
  unsigned char* over;
  unsigned char* over_supers;
  unsigned char* over_clusters;
  unsigned char* phantom_only;
  float t_min;
  int n, c, n_boxes, ss, levels, k_supers, k_clusters, list;
};

__global__ void __launch_bounds__(RC_WARPS * 32)
    kslots_cull_kernel(const KsArgs a) {
  extern __shared__ int sup_lists[];  // RC_WARPS x a.list
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RC_WARPS + warp;
  if (ray >= a.n) return;  // whole warps leave; there is no block barrier
  const float tm = __ldg(a.tm + ray);
  // live = t_max >= 0; a dead (or NaN) ray's window ends at -inf
  const RayIn r = load_ray(a.o, a.d, ray, a.t_min,
                           tm >= 0.0f ? tm : -INFINITY);
  const bool any = r.hi0 >= r.lo0;
  int* row = a.cid + (size_t)ray * a.k_clusters;
  int count = 0, n_real = 0, pad = a.c - 1;
  bool over_s = false;
  if (a.levels == 1) {
    for (int c0 = 0; any && c0 < a.n_boxes; c0 += 32) {
      const int k = c0 + lane;
      const bool hit = k < a.n_boxes &&
                       kslots_slab(r, a.bmin + 3 * k, a.bmax + 3 * k);
      count += put_ids(row, a.k_clusters, hit, k, lane, count);
    }
  } else {
    int* sup = sup_lists + warp * a.list;
    int ns = 0;
    for (int s0 = 0; any && s0 < a.n_boxes && !over_s; s0 += 32) {
      const int sid = s0 + lane;
      const bool hit = sid < a.n_boxes &&
                       kslots_slab(r, a.bmin + 3 * sid, a.bmax + 3 * sid);
      ns += put_ids(sup, a.list, hit, sid, lane, ns);
      over_s = ns > a.k_supers;
    }
    __syncwarp();  // the list is written
    const int listed = ns < a.k_supers ? ns : a.k_supers;
    const int last = ns >= a.k_supers ? sup[a.k_supers - 1] : a.n_boxes - 1;
    pad = min(last * a.ss + a.ss - 1, a.c - 1);
    const int pairs = listed * a.ss;
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      const int p = p0 + lane;
      bool hit = false;
      int child = 0;
      if (p < pairs) {
        const int si = p / a.ss;
        child = sup[si] * a.ss + (p - si * a.ss);
        hit = kslots_slab(r, a.cbmin + 3 * (size_t)child,
                          a.cbmax + 3 * (size_t)child);
      }
      n_real += __popc(__ballot_sync(FULL_MASK, hit && child < a.c));
      count += put_ids(row, a.k_clusters, hit, min(child, a.c - 1), lane,
                       count);
    }
  }
  const bool over = over_s || count > a.k_clusters;
  __syncwarp();  // the ids are written before the pad may replace them
  for (int j = (over ? 0 : count) + lane; j < a.k_clusters; j += 32)
    row[j] = pad;
  if (lane == 0) {
    a.n_cand[ray] = count;
    a.n_slots[ray] = over ? 0 : count;
    a.over[ray] = over;
    a.over_supers[ray] = over_s;
    a.over_clusters[ray] = over && !over_s;
    a.phantom_only[ray] =
        a.levels == 2 && over && !over_s && n_real <= a.k_clusters;
  }
}

struct PrArgs {
  const float* o;
  const float* d;
  const float* tm;
  const float* bmin;  // [C, 3]
  const float* bmax;
  int* order;
  int* n_cand;
  unsigned char* overflow;
  float t_min;
  int n, c, cap;
};

__global__ void __launch_bounds__(RC_WARPS * 32)
    perray_cull_kernel(const PrArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RC_WARPS + warp;
  if (ray >= a.n) return;
  const RayIn r = load_ray(a.o, a.d, ray, a.t_min, __ldg(a.tm + ray));
  const int kx = a.cap < a.c ? a.cap : a.c;
  int* row = a.order + (size_t)ray * a.cap;
  int count = 0;
  // a NaN t_max fails hi0 >= lo0: no candidate
  for (int c0 = 0; r.hi0 >= r.lo0 && c0 < a.c && count <= a.cap; c0 += 32) {
    const int k = c0 + lane;
    const bool hit = k < a.c && perray_slab(r, a.bmin + 3 * k, a.bmax + 3 * k);
    count += put_ids(row, kx, hit, k, lane, count);
  }
  for (int j = (count < kx ? count : kx) + lane; j < a.cap; j += 32)
    row[j] = j < kx ? a.c - 1 : 0;
  if (lane == 0) {
    a.n_cand[ray] = count < a.cap ? count : a.cap;
    a.overflow[ray] = count > a.cap;
  }
}

static int grid_of(int n) { return (n + RC_WARPS - 1) / RC_WARPS; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// levels 1: bmin / bmax are the n_boxes = C cluster boxes, cbmin / cbmax
// unused; levels 2: bmin / bmax the n_boxes = Cs super boxes, cbmin /
// cbmax the [Cs, ss, 3] children, k_supers >= 1.
extern "C" int kslots_cull(const void* o, const void* d, const void* tm,
                           float t_min, const void* bmin, const void* bmax,
                           const void* cbmin, const void* cbmax, int n, int c,
                           int n_boxes, int ss, int levels, int k_supers,
                           int k_clusters, void* cid, void* n_cand,
                           void* n_slots, void* over, void* over_supers,
                           void* over_clusters, void* phantom_only,
                           void* stream) {
  if (n <= 0) return 0;
  const int list = k_supers < n_boxes ? k_supers : n_boxes;
  if (c < 1 || n_boxes < 1 || k_clusters < 0 ||
      (levels != 1 && levels != 2) ||
      (levels == 2 && (ss < 1 || k_supers < 1 || list > RC_MAX_SUPERS ||
                       cbmin == nullptr || cbmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  const KsArgs a = {(const float*)o, (const float*)d, (const float*)tm,
                    (const float*)bmin, (const float*)bmax,
                    (const float*)cbmin, (const float*)cbmax, (int*)cid,
                    (int*)n_cand, (int*)n_slots, (unsigned char*)over,
                    (unsigned char*)over_supers,
                    (unsigned char*)over_clusters,
                    (unsigned char*)phantom_only, t_min, n, c, n_boxes, ss,
                    levels, k_supers, k_clusters, levels == 2 ? list : 0};
  // at most 48 KB (RC_MAX_SUPERS): no attribute to raise
  const size_t smem = (size_t)RC_WARPS * a.list * sizeof(int);
  kslots_cull_kernel<<<grid_of(n), RC_WARPS * 32, smem,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int perray_cull(const void* o, const void* d, const void* tm,
                           float t_min, const void* bmin, const void* bmax,
                           int n, int c, int cap, void* order, void* n_cand,
                           void* overflow, void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  const PrArgs a = {(const float*)o, (const float*)d, (const float*)tm,
                    (const float*)bmin, (const float*)bmax, (int*)order,
                    (int*)n_cand, (unsigned char*)overflow, t_min, n, c,
                    cap};
  perray_cull_kernel<<<grid_of(n), RC_WARPS * 32, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename K>
static int occupancy(K kernel, size_t smem, int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      RC_WARPS * 32, smem);
  *warps_per_sm = blocks * RC_WARPS;
  return (int)err;
}

// Registers per thread and resident warps per SM (kslots_cull with a list
// of `list` supers a warp).
extern "C" int kslots_cull_occupancy(int list, int* regs, int* warps_per_sm) {
  return occupancy(kslots_cull_kernel, (size_t)RC_WARPS * list * sizeof(int),
                   regs, warps_per_sm);
}

extern "C" int perray_cull_occupancy(int* regs, int* warps_per_sm) {
  return occupancy(perray_cull_kernel, 0, regs, warps_per_sm);
}
