// Per-ray K-slot Möller–Trumbore sweep of the kslots backend for Hopper
// (sm_90a).
//
// What it replaces: no Pallas kernel stands behind it; it carries the
// XLA-fused SWEEP and RESOLVE of path_tracer_ai_tpu/accel/kslots.py
// `_chunk_pipeline` (kslots.py:165-185). Ray r tests the S triangles of
// each cluster cid[r, k] for k < n_slots[r] within [t_min[r], t_max[r]]; a
// ray whose t_max < t_min (dead, or overflowed to the fallback: t_max = -1)
// tests nothing, and so does a slot whose cid lies outside [0, C). Closest
// hit: the minimum t over the passing tests, then the minimum triangle id
// among the tests at that t (the brute-force oracle's lexicographic rule,
// kslots.py:178-184), or (+inf, INT32_MAX). Any hit: whether some test
// passes.
//
// The first-slot closest instance (mode 2, FIRST) carries the closest
// sweep of path_tracer_ai_tpu/accel/traverse.py `closest_hit_perray`
// (traverse.py:648-665, XLA-fused there, no Pallas kernel): the minimum t
// and the triangle id of the FIRST slot that reaches it, slot k * S + j for
// triangle j of the row's cluster k (jnp.argmin's rule), or (+inf,
// INT32_MAX). Each lane meets its own slots in ascending order and keeps
// the first at its minimum (strict t < best_t) with its slot; the warp then
// takes the least key of t, the least slot among the lanes at it, and that
// lane's t and id. The perray any-hit query (traverse.py:727-738) is the
// any-hit mode as it is: each ray against its iteration's g clusters. The
// perray queries run these walks inside the stage kernel's perray folds
// (kslot_walk; the end of this file); the standalone launches serve the
// kslots backend and the perray queries' host-stepped comparison loop.
//
// Layouts (see accel/cuda_kslots.py):
//   tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris): rows v0.xyz e1.xyz
//            e2.xyz, row 9 = the triangle id bit-cast to f32.
//   rays     [N, 8] f32: ox oy oz dx dy dz t_max t_min.
//   cid      [N, K] i32 cluster ids; n_slots [N] i32 live slots of a row.
//   out_a    [N] f32 t (closest) or u8 occluded (any hit);
//   out_b    [N] i32 tri (closest only).
//
// What bounds it on the H100: instruction issue. On the kslots closest
// check wave (2^20 bounce-like rays, K 12, S 128; PERF.md §6, timed by
// scripts/torch_sweep_variants.py) the earlier flat walk took 0.93 ms; its
// loads, cid reads and walk alone (a sum in place of each test) about
// 0.52 ms, and its tests alone, on a triangle held in registers, about
// 0.67 ms, 4.9x the operations bound before any load. A test is ~110
// instructions here (--fmad=false: each multiply and add its own), so
// more loads in flight do not pay: two or four trips' loads at once a lane
// took 3-23% longer than one (more registers, fewer warps), and a block
// that shares a cluster's loads among its rays gains little where 128
// consecutive rays name a cluster 2.4 times (the check waves).
//
// Design: one warp a ray. Its clusters are walked slot by slot (one
// warp-uniform cid read a slot), each cluster's S triangles in trips of
// 32, lane l on triangle j0 + l, its ten rows read straight from the pack
// (coalesced 128-byte rows); where S is a multiple of 128 four trips make
// one iteration, their loads at fixed offsets from one set of row
// addresses. Below 32 triangles a cluster, a trip takes 32 / S slots (lane
// l on triangle l % S of slot l / S), so no lane idles at S = 2 or 16.
// One test a lane a trip, with one warp-uniform branch for the reciprocal
// and a vote after u that skips v and t where no lane can pass (10% of
// the closest wave). Each lane keeps its own (t, tri) and folds it
// lexicographically; the warp then takes the least key of t and the least
// id at it (two redux). The any-hit walk votes after every trip and leaves
// once a lane has hit. A dead ray, or one with no slot, only writes its
// miss. Blocks of four warps, twelve an SM (40 registers a thread: 5%
// faster on the closest wave than 48 registers at 40 warps). One body
// serves every S: a template constant in the tuned instances (S in {2,
// 128}), a run-time value in the generic one, whose ten row addresses an
// iteration take a chain of ten multiply-adds and twenty registers, so it
// cannot issue the next trip's loads early as the tuned one does (1.35x
// the tuned time at S = 128).
//
// Exactness: mt.cuh's Möller–Trumbore (traverse._mt_sweep's op order, the
// reciprocal with the IEEE division's bits; build with --fmad=false); the
// lexicographic fold gives the same (t, tri) in any order of the slots,
// and the any-hit OR is exact whichever test finds the hit first.

#include "mt.cuh"
#include "stage.cuh"

#define PACK_ROWS 10
#define KSLOT_WARPS 4        // rays (warps) a thread block
#define KSLOT_MIN_BLOCKS 12  // blocks an SM: 48 warps, 40 registers a thread
#define KSLOT_UNROLL 4       // trips of 32 triangles an iteration of the walk

// One test a lane: the ray against triangle tr (id tid; the zero triangle
// where the lane has none). rcp_fast serves the whole warp unless some lane
// has a determinant of 2^126 or more, and then the IEEE division does (one
// warp-uniform branch; both give the division's bits where both apply); v
// and t are skipped where no lane has 0 <= u <= 1. Returns whether the test
// passes; with CLOSEST, folds a pass into (best_t, best_tri) by the
// lexicographic rule, or with FIRST into (best_t, best_tri, best_slot) only
// where t < best_t (`slot` is the test's slot in the row).
template <bool CLOSEST, bool FIRST = false>
__device__ __forceinline__ bool test_tri(const Ray& ray, const Tri& tr,
                                         int tid, float tmin, float tmax,
                                         float* best_t, int* best_tri,
                                         int slot = 0,
                                         int* best_slot = nullptr) {
  Vec3 h, sv;
  const float det = mt_det(ray, tr, &h);
  bool ok = fabsf(det) > MT_EPSILON;
  const float x = ok ? det : 1.0f;
  float f;
  if (__all_sync(FULL_MASK, fabsf(x) < RCP_FAST_BELOW)) {
    f = rcp_fast(x);
  } else {
    f = 1.0f / x;
  }
  const float u = mt_u(ray, tr, h, f, &sv);
  ok = ok && (u >= 0.0f) && (u <= 1.0f);
  if (!__any_sync(FULL_MASK, ok)) return false;
  float t;
  const bool pass = mt_vt(ray, tr, sv, f, u, ok, tmin, tmax, &t);
  if constexpr (CLOSEST && FIRST) {
    if (pass && t < *best_t) {
      *best_t = t;
      *best_tri = tid;
      *best_slot = slot;
    }
  } else if constexpr (CLOSEST) {
    if (pass) fold_min_tri(t, tid, best_t, best_tri);
  }
  return pass;
}

// The ray against the s triangles of the cluster whose row 0 starts at
// base - lane, in trips of 32 triangles (lane l on triangle j0 + l), U
// trips an iteration: their loads at fixed offsets from one set of row
// addresses. TAIL: s may not be a multiple of 32, and lanes past it test
// the zero triangle. Returns, for an any-hit walk, whether some lane has hit
// (the walk leaves at the trip that found it). FIRST: test_tri's, the
// cluster's slots starting at slot0.
template <int U, bool TAIL, bool CLOSEST, bool FIRST = false>
__device__ __forceinline__ bool walk_cluster(const float* __restrict__ base,
                                             int s, int lane, const Ray& ray,
                                             float tmin, float tmax,
                                             float* best_t, int* best_tri,
                                             int slot0 = 0,
                                             int* best_slot = nullptr) {
  for (int j0 = 0; j0 < s; j0 += 32 * U) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = j0 + 32 * q;
      int tid;
      const Tri tr = !TAIL || j + lane < s
                         ? load_column(base + j, s, &tid)
                         : load_column_or_zero(nullptr, s, &tid);
      const bool hit = test_tri<CLOSEST, FIRST>(
          ray, tr, tid, tmin, tmax, best_t, best_tri, slot0 + j + lane,
          best_slot);
      if constexpr (!CLOSEST) {
        if (__any_sync(FULL_MASK, hit)) return true;
      }
    }
  }
  return false;
}

// One warp's walk of a ray over the ns clusters rc[0 .. ns) (see the
// header): ids outside [0, n_clusters) test nothing. S_T is S as a
// template constant, or 0 for S = s at run time. Folds the passing tests
// into each lane's (best_t, best_tri) (CLOSEST) and best_slot (FIRST, the
// first-slot rule); returns, for an any-hit walk, whether some lane has
// hit (the walk then ends). Shared by kslot_sweep_kernel and the perray
// stage folds, so both run this code.
template <int S_T, bool CLOSEST, bool FIRST = false>
__device__ __forceinline__ bool kslot_walk(const float* __restrict__ tri_pack,
                                           const int* __restrict__ rc,
                                           int ns,
                                           int n_clusters, int s, int lane,
                                           const Ray& ray, float tmin,
                                           float tmax, float* best_t,
                                           int* best_tri, int* best_slot) {
  bool occ = false;  // any hit: set once, and the walk ends
  if (s >= 32) {
    // slot by slot, each cluster by walk_cluster: KSLOT_UNROLL trips an
    // iteration where S is a multiple of their 32 * KSLOT_UNROLL triangles
    constexpr int W = 32 * KSLOT_UNROLL;
    for (int k = 0; k < ns && !occ; ++k) {
      const int c = rc[k];
      if (c < 0 || c >= n_clusters) continue;  // warp-uniform
      const float* base = tri_pack + (size_t)c * PACK_ROWS * s + lane;
      if (S_T > 0 ? S_T % W == 0 : s % W == 0) {
        occ = walk_cluster<KSLOT_UNROLL, false, CLOSEST, FIRST>(
            base, s, lane, ray, tmin, tmax, best_t, best_tri, k * s,
            best_slot);
      } else {
        occ = walk_cluster<1, true, CLOSEST, FIRST>(
            base, s, lane, ray, tmin, tmax, best_t, best_tri, k * s,
            best_slot);
      }
    }
  } else {
    // 32 / s slots a trip, lane l on triangle l % s of slot l / s
    const int per = 32 / s;
    const int ks = lane / s;
    const int jl = lane - ks * s;
    for (int k0 = 0; k0 < ns && !occ; k0 += per) {
      const int k = k0 + ks;
      const int c = (ks < per && k < ns) ? rc[k] : -1;
      int tid;
      const Tri tr = load_column_or_zero(
          c >= 0 && c < n_clusters ? tri_pack + (size_t)c * PACK_ROWS * s + jl
                                   : nullptr,
          s, &tid);
      const bool hit = test_tri<CLOSEST, FIRST>(
          ray, tr, tid, tmin, tmax, best_t, best_tri, k * s + jl, best_slot);
      if constexpr (!CLOSEST) occ = __any_sync(FULL_MASK, hit);
    }
  }
  return occ;
}

// The warp's first-slot result from each lane's (best_t, best_tri,
// best_slot): the least t, then the least slot among the lanes at it, and
// that lane's (t, tri), in every lane; with no hit every lane holds (inf,
// INT32_MAX, INT32_MAX).
__device__ __forceinline__ void first_slot_reduce(float best_t, int best_tri,
                                                  int best_slot, float* t_out,
                                                  int* tri_out) {
  const float t = key_float(__reduce_min_sync(FULL_MASK, order_key(best_t)));
  const unsigned at = best_t == t ? (unsigned)best_slot : 0xffffffffu;
  const unsigned slot = __reduce_min_sync(FULL_MASK, at);
  const int src = __ffs(__ballot_sync(FULL_MASK, at == slot)) - 1;
  *t_out = __shfl_sync(FULL_MASK, best_t, src);
  *tri_out = __shfl_sync(FULL_MASK, best_tri, src);
}

// One warp a ray (see the header); S_T as kslot_walk's. FIRST (with
// CLOSEST): the first-slot rule.
template <int S_T, bool CLOSEST, bool FIRST = false>
__global__ void __launch_bounds__(32 * KSLOT_WARPS, KSLOT_MIN_BLOCKS)
    kslot_sweep_kernel(const float* __restrict__ tri_pack,
                       const float* __restrict__ rays,
                       const int* __restrict__ cid,
                       const int* __restrict__ n_slots,
                       void* __restrict__ out_a, int* __restrict__ out_b,
                       int n_rays, int k_slots, int n_clusters, int s_run) {
  const int s = S_T > 0 ? S_T : s_run;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * KSLOT_WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // warp-uniform

  const float* rp = rays + (size_t)r * RAY_ROWS;
  const Ray ray = {rp[0], rp[1], rp[2], rp[3], rp[4], rp[5]};
  const float tmax = rp[6], tmin = rp[7];
  int ns = n_slots[r];
  ns = ns < 0 ? 0 : (ns > k_slots ? k_slots : ns);
  if (!(tmax >= tmin) || ns == 0) {  // dead, or no slot: a miss
    if (lane == 0) {
      if constexpr (CLOSEST) {
        reinterpret_cast<float*>(out_a)[r] = INFINITY;
        out_b[r] = I32_MAX;
      } else {
        reinterpret_cast<unsigned char*>(out_a)[r] = 0;
      }
    }
    return;
  }

  float best_t = INFINITY;
  int best_tri = I32_MAX;
  int best_slot = I32_MAX;  // FIRST only
  const bool occ = kslot_walk<S_T, CLOSEST, FIRST>(
      tri_pack, cid + (size_t)r * k_slots, ns, n_clusters, s, lane, ray, tmin,
      tmax, &best_t, &best_tri, &best_slot);

  if constexpr (CLOSEST && FIRST) {
    float t;
    int tri;
    first_slot_reduce(best_t, best_tri, best_slot, &t, &tri);
    if (lane == 0) {
      reinterpret_cast<float*>(out_a)[r] = t;
      out_b[r] = tri;
    }
  } else if constexpr (CLOSEST) {
    const float t =
        key_float(__reduce_min_sync(FULL_MASK, order_key(best_t)));
    const int tri = __reduce_min_sync(FULL_MASK,
                                      best_t == t ? best_tri : I32_MAX);
    if (lane == 0) {
      reinterpret_cast<float*>(out_a)[r] = t;
      out_b[r] = tri;
    }
  } else {
    if (lane == 0) reinterpret_cast<unsigned char*>(out_a)[r] = occ;
  }
}

template <int S_T, bool CLOSEST, bool FIRST = false>
static int launch(const void* tri_pack, const void* rays, const void* cid,
                  const void* n_slots, void* out_a, void* out_b, int n_rays,
                  int k_slots, int n_clusters, int s, cudaStream_t stream) {
  const int blocks = (n_rays + KSLOT_WARPS - 1) / KSLOT_WARPS;
  kslot_sweep_kernel<S_T, CLOSEST, FIRST>
      <<<blocks, 32 * KSLOT_WARPS, 0, stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid,
      (const int*)n_slots, out_a, (int*)out_b, n_rays, k_slots, n_clusters,
      s);
  return (int)cudaGetLastError();
}

template <int S_T, bool CLOSEST, bool FIRST = false>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, kslot_sweep_kernel<S_T, CLOSEST, FIRST>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kslot_sweep_kernel<S_T, CLOSEST, FIRST>, 32 * KSLOT_WARPS, 0);
  *warps_per_sm = blocks * KSLOT_WARPS;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_KSLOT_INSTANCES(CALL) CALL(2) CALL(128)
// `closest`: 0 any hit, 1 closest (the oracle's rule), 2 closest (the first
// slot's rule)
#define MODE_FIRST 2

// The instance of mode `closest` at S_T (0: S = s at run time).
template <int S_T>
static int launch_mode(const void* tri_pack, const void* rays, const void* cid,
                       const void* n_slots, void* out_a, void* out_b,
                       int n_rays, int k_slots, int n_clusters, int s,
                       int closest, cudaStream_t stream) {
  if (closest == MODE_FIRST) {
    return launch<S_T, true, true>(tri_pack, rays, cid, n_slots, out_a, out_b,
                                   n_rays, k_slots, n_clusters, s, stream);
  }
  if (closest == 1) {
    return launch<S_T, true>(tri_pack, rays, cid, n_slots, out_a, out_b,
                             n_rays, k_slots, n_clusters, s, stream);
  }
  if (closest == 0) {
    return launch<S_T, false>(tri_pack, rays, cid, n_slots, out_a, out_b,
                              n_rays, k_slots, n_clusters, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` over rays [0, n_rays): one warp a ray, KSLOT_WARPS
// rays a thread block. Returns the cudaError_t of the launch (0 = ok), or
// NO_INSTANCE for an S that is not compiled (S in {2, 128}).
extern "C" int kslot_sweep(const void* tri_pack, const void* rays,
                           const void* cid, const void* n_slots, void* out_a,
                           void* out_b, int n_rays, int k_slots, int s,
                           int n_clusters, int closest, void* stream) {
  if (n_rays <= 0) return 0;
  if (k_slots < 1) return NO_INSTANCE;
#define LAUNCH(S_)                                                        \
  if (s == S_)                                                            \
    return launch_mode<S_>(tri_pack, rays, cid, n_slots, out_a, out_b,    \
                           n_rays, k_slots, n_clusters, s, closest,       \
                           (cudaStream_t)stream);
  FOR_KSLOT_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, mode `closest`) instance and the warps an
// SM holds of it (S = 0: the generic instance).
extern "C" int kslot_sweep_occupancy(int s, int closest, int* regs,
                                     int* warps_per_sm) {
#define OCCUPANCY(S_)                                                   \
  if (s == S_)                                                          \
    return closest == MODE_FIRST                                        \
               ? occupancy<S_, true, true>(regs, warps_per_sm)          \
               : closest ? occupancy<S_, true>(regs, warps_per_sm)      \
                         : occupancy<S_, false>(regs, warps_per_sm);
  FOR_KSLOT_INSTANCES(OCCUPANCY)
  OCCUPANCY(0)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// kslot_sweep's generic instance, with its arguments, for any S >= 1: the
// same body with S at run time.
extern "C" int kslot_sweep_generic(const void* tri_pack, const void* rays,
                                   const void* cid, const void* n_slots,
                                   void* out_a, void* out_b, int n_rays,
                                   int k_slots, int s, int n_clusters,
                                   int closest, void* stream) {
  if (n_rays <= 0) return 0;
  if (k_slots < 1) return NO_INSTANCE;
  if (s < 1) return (int)cudaErrorInvalidValue;
  return launch_mode<0>(tri_pack, rays, cid, n_slots, out_a, out_b, n_rays,
                        k_slots, n_clusters, s, closest, (cudaStream_t)stream);
}

// ---- the perray queries' stage: one stage as one launch -------------------
//
// The perray queries' loop (closest_hit_perray, any_hit_perray:
// traverse._cascade_stages, min_blocks 1024) runs each stage as one
// cooperative launch of stage.cuh's kernel with these folds: ray blocks of
// ONE ray (rays [size, 8, 1], T = 1: the stage loop's first pass gives a
// ray a warp, of which lane 0 votes), order_g [size, kgroups, g] the ray's
// candidate clusters in id order. Both folds take the open rule (ANY): a
// ray's vote only closes, so the sweep set is act, as the loop stepped on
// the host swept its active rays; there the JAX package's active_fn
// (traverse.py:648-665, 727-738): any hit, act = k g < n_cand & not
// occluded (a dead ray is active until it runs out of candidates, and
// tests nothing); closest, act = k g < n_cand & t_max >= 0 (no entry rule:
// the candidates come in id order; a NaN t_max is not active).
//
// The sweep of a listed ray is kslot_sweep_kernel's walk of one ray
// (kslot_walk): its warp takes the g clusters of group min(k, kgroups - 1),
// ALL g slots, the filler ids past n_cand too (the reference sweeps the
// whole group; ids outside [0, C) test nothing), the S triangles of each
// 32 lanes a trip. Any hit: the walk leaves once a lane has hit, and the
// carry becomes occluded. Closest: the first-slot walk on the window
// [t_min, torch.minimum(t_max, best_t)], reduced by first_slot_reduce, and
// the carry replaced only where that t < best_t (the first group at the
// minimum keeps it). The bits are those of kslot_sweep launched on the
// active rays once an iteration. One warp a ray (W = 1): a stage's tail
// is a few thousand rays, each 16 trips long at g 4, S 128. One instance,
// S at run time (perray_stage).
//
// What bounds it: kslot_sweep's walk, instruction issue (about 110
// instructions a test under --fmad=false), and at the tail stages the
// latency of one ray's walk; the stage loop keeps 8-warp thread blocks, at
// most 80 registers a thread.
template <bool CLOSEST>
struct PerrayFold {
  static constexpr bool ANY = true;  // the open rule (see above)
  template <int S>
  __host__ __device__ static constexpr size_t warp_bytes() {
    return 0;
  }
  template <int T>
  static __device__ __forceinline__ unsigned first_vote(const StageArgs& a,
                                                        int b, int) {
    if constexpr (CLOSEST) {
      return a.rays[(size_t)b * RAY_ROWS + 6] >= 0.0f ? 1u : 0u;
    } else {
      return __ldcg(a.occ + b) != 0 ? 0u : 1u;
    }
  }
  template <int S, int T>
  static __device__ __forceinline__ unsigned sweep(
      const StageArgs& a, StageShared&, int b, int, int k, int, int, int,
      int, int lane, unsigned char*) {
    const float* rp = a.rays + (size_t)b * RAY_ROWS;
    const Ray ray = {rp[0], rp[1], rp[2], rp[3], rp[4], rp[5]};
    const float tmax = rp[6], tmin = rp[7];
    const int kk = k < a.kgroups - 1 ? k : a.kgroups - 1;
    const int* rc = a.order_g + ((size_t)b * a.kgroups + kk) * a.g;
    float best_t = INFINITY;
    int best_tri = I32_MAX;
    int best_slot = I32_MAX;
    if constexpr (CLOSEST) {
      const float bt = __ldcg(a.best_t + b);
      // torch.minimum: a NaN t_max stays NaN and passes no test
      const float cap = tmax != tmax ? tmax : fminf(tmax, bt);
      if (cap >= tmin) {  // warp-uniform
        kslot_walk<S, true, true>(a.tri_pack, rc, a.g, a.n_clusters, a.s,
                                  lane, ray, tmin, cap, &best_t, &best_tri,
                                  &best_slot);
      }
      float t;
      int tri;
      first_slot_reduce(best_t, best_tri, best_slot, &t, &tri);
      if (lane == 0 && t < bt) {
        a.best_t[b] = t;
        a.best_id[b] = tri;
      }
      return tmax >= 0.0f ? 1u : 0u;
    } else {
      // a listed ray is not occluded
      const bool occ =
          tmax >= tmin &&
          kslot_walk<S, false>(a.tri_pack, rc, a.g, a.n_clusters, a.s, lane,
                               ray, tmin, tmax, &best_t, &best_tri,
                               &best_slot);
      if (lane == 0 && occ) a.occ[b] = 1;
      return occ ? 0u : 1u;
    }
  }
};
using PerrayAny = PerrayFold<false>;
using PerrayFirst = PerrayFold<true>;

static StageArgs perray_args(const void* tri_pack, const void* rays,
                             const void* order_g, const void* n_cand,
                             void* occ, void* best_t, void* best_id,
                             void* k_io, void* act, void* work, int size,
                             int kgroups, int g, int s, int n_clusters,
                             int threshold) {
  unsigned* words = (unsigned*)work;
  return StageArgs{(const float*)tri_pack, (const float*)rays,
                   (const int*)order_g, (const int*)n_cand, nullptr,
                   (unsigned char*)occ, (float*)best_t, (int*)best_id,
                   (int*)k_io, (unsigned char*)act,
                   (unsigned long long*)words, words + STAGE_SYNC_WORDS,
                   words + STAGE_SYNC_WORDS + size,
                   (int*)(words + STAGE_SYNC_WORDS + 2 * (size_t)size),
                   size, kgroups, g, s, 1, n_clusters, 0, threshold, 1, 0,
                   nullptr};
}

// One stage of a perray query on `stream`, for any S >= 1: tri_pack [C,
// 10, S], rays [size, 8, 1], order_g [size, kgroups, g], n_cand [size];
// any_hit 1 with occ [size] u8, 0 (first-slot closest) with best_t [size]
// f32 and best_id [size] i32 (the carry); k_io [1], act [size] u8; work:
// 14 + 4 size 32-bit words, the first 14 + 2 size zero. Returns the
// cudaError_t of the launch (0 = ok). One instance, S at run time: an
// instance at S 128 took the same time or longer on every stage of the
// perray bench render's kept calls (PERF.md §6).
extern "C" int perray_stage(const void* tri_pack, const void* rays,
                            const void* order_g, const void* n_cand,
                            void* occ, void* best_t, void* best_id,
                            void* k_io, void* act, void* work, int size,
                            int kgroups, int g, int s, int n_clusters,
                            int threshold, int any_hit, void* stream) {
  if (size <= 0) return 0;
  if (g < 1 || kgroups < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const StageArgs a =
      perray_args(tri_pack, rays, order_g, n_cand, occ, best_t, best_id,
                  k_io, act, work, size, kgroups, g, s, n_clusters, threshold);
  return any_hit ? launch_stage<PerrayAny, 0, 1>(a, (cudaStream_t)stream)
                 : launch_stage<PerrayFirst, 0, 1>(a, (cudaStream_t)stream);
}

// Registers per thread and resident warps per SM of a perray fold.
extern "C" int perray_stage_occupancy(int any_hit, int* regs,
                                      int* warps_per_sm) {
  return any_hit ? stage_occupancy<PerrayAny, 0, 1>(regs, warps_per_sm)
                 : stage_occupancy<PerrayFirst, 0, 1>(regs, warps_per_sm);
}
