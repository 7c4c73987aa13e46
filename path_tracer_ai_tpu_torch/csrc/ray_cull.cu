// The per-ray culls for Hopper (sm_90a): kslots_cull, perray_cull,
// perray_entry and the pair tables' cull (pair_cull, pair_scan, pair_rank).
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
//     against every cluster box and its first cap candidate ids ascending;
//   perray_entry: `_perray_candidates` in order_mode "entry" (the same
//     lines), the same test and the first min(cap, C) clusters by (entry,
//     id), a stable argsort of the row with the non-candidates at +inf;
//   the pair tables: the CULL + PACK of path_tracer_ai_tpu/accel/pairs.py
//     `build_pair_tables` (pairs.py:61-190), each ray's slab test against
//     every cluster box, its candidates' ranks inside their clusters'
//     segments in ray order (the lax.scan's carry of per-cluster counts),
//     the segments padded to whole tiles, and the cluster-major table.
// JAX runs each as a lax.map or lax.scan over row chunks inside one
// executable; the port's plain versions (accel/cuda_cull.py
// kslots_cull_plain, perray_cull_plain, pair_tables_plain) as chains of
// eager ops over [rows, boxes] temporaries.
//
// The slab rules are ray_slab.cuh's: kslots' for kslots_cull, perray's
// comparison-select form for perray_cull and the pair tables (pairs.py's
// `_ray_slab_chunk` is the same rule, with every ray whose t_max is not
// >= 0 dead).
//
// Layouts (accel/cuda_cull.py): o, d [N, 3] f32, tm [N] f32 (t_max), all
// contiguous; boxes bmin, bmax [C, 3] (levels 1, perray, pairs) or the
// supers sbmin, sbmax [Cs, 3] and the children cbmin, cbmax [Cs, ss, 3]
// (levels 2).
//   kslots_cull: cid [N, k_clusters] i32 (the first ids ascending, each
//   clamped to C - 1; every slot past the count, and every slot of an
//   overflowing ray, holds the pad below); n_cand, n_slots [N] i32; over,
//   over_supers, over_clusters, phantom_only [N] u8.
//   perray_cull: order [N, cap] i32 (the first min(cap, C) candidate ids
//   ascending, also for an overflowing ray; C - 1 past the count up to
//   min(cap, C), 0 from C to cap); n_cand [N] i32 clipped to cap;
//   overflow [N] u8 (more than cap candidates).
//   perray_entry: order [N, cap] i32 and entry [N, cap] f32: the
//   candidates of finite entry lo by (lo, id), then the other ids
//   ascending at +inf, min(cap, C) of them; (0, +inf) from C to cap;
//   n_cand [N] i32 clipped to cap, overflow [N] u8 as perray_cull's.
//   the pair tables: pair_ray [P] i32 (filled with -1 by the caller),
//   tile_cluster [P / T] i32, dst [N, cap] i32, n_cand [N] i32, overflow
//   [N] u8, n_tiles [1] i32; the scratch order [N, k_eff] i32, hist [NT,
//   C] i32 and base [C] i32 (NT ray tiles of rt rays).
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
// perray_entry scans every box: its row is a top-min(cap, C) selection,
// kept sorted in the output row itself (each finite candidate, in id
// order, goes in after the entries <= its own, the warp shifting the rest
// down a slot; once the row is full, only one below its last), then the
// ids of no finite entry fill the rest of the row from a second scan.
//
// The pair tables, for N rays, C clusters, cap, k_eff = min(cap, C), tile
// T and the pair capacity P (pairs.py:138-166 for the steps after the
// rank):
//   1. pair_cull, a thread block a ray tile of rt rays, a warp a ray (as
//      perray_cull): the ray's candidates, scanned until the count passes
//      cap. A ray whose t_max is not >= 0, or has more than cap
//      candidates, gets none: n_cand 0 (else its count), overflow set for
//      the latter. The first n_cand ids ascending go to its order row, and
//      each one to the tile's row of hist (shared atomics are not needed:
//      counts do not depend on order, so global atomicAdd into the row the
//      block zeroed first).
//   2. pair_scan, one thread block: hist's columns become exclusive offsets
//      down the tiles (a thread a cluster), the totals are the cluster
//      counts; seg = counts rounded up to whole tiles of T, base its
//      exclusive scan, n_tiles = min(sum seg, P) / T; tile_cluster[i] the
//      last cluster whose base is <= i T (searchsorted, right), clamped to
//      [0, C - 1].
//   3. pair_rank, a warp a ray tile (shared memory holds the tile's
//      running offsets where C fits, else its hist row does): the tile's
//      rays in ray order, their at most cap candidates on the lanes (a
//      ray's candidates are distinct clusters, so no two lanes meet).
//      rank = running[c]++, dst = base[c] + rank. A ray with any dst >= P
//      is over budget: n_cand 0, overflow set, its dst row all P (its
//      pairs stay in the counts, as the reference computes seg before the
//      budget); else its dst row (P past n_cand, and from k_eff to cap)
//      and pair_ray[dst] = ray.
//   The rank is the number of rays before the ray, not over cap, that
//   hold the cluster: the tables depend on neither rt nor any row chunk.
//
// What bounds it: the box tests' operations (chip_smoke.py
// KSLOTS_TEST_OPS, PERRAY_TEST_OPS a box; no division per box, one IEEE
// division per ray and axis), counted over the boxes this run's rays
// test, against the rays in and the tables out.

#include <cuda_runtime.h>
#include <math.h>

#include "ray_slab.cuh"

#define RC_WARPS 8  // warps (rays) a thread block
// the largest super list a warp keeps (min(k_supers, Cs) ints a warp, in
// RC_WARPS * RC_MAX_SUPERS * 4 bytes of shared memory at most)
#define RC_MAX_SUPERS 1536

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
      bool hit = false;
      if (k < a.n_boxes) {
        float lo[3], hi[3];
        load_box(a.bmin + 3 * (size_t)k, lo);
        load_box(a.bmax + 3 * (size_t)k, hi);
        hit = kslots_slab(r, lo, hi);
      }
      count += put_ids(row, a.k_clusters, hit, k, lane, count);
    }
  } else {
    int* sup = sup_lists + warp * a.list;
    int ns = 0;
    for (int s0 = 0; any && s0 < a.n_boxes && !over_s; s0 += 32) {
      const int sid = s0 + lane;
      bool hit = false;
      if (sid < a.n_boxes) {
        float lo[3], hi[3];
        load_box(a.bmin + 3 * (size_t)sid, lo);
        load_box(a.bmax + 3 * (size_t)sid, hi);
        hit = kslots_slab(r, lo, hi);
      }
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
        float lo[3], hi[3];
        load_box(a.cbmin + 3 * (size_t)child, lo);
        load_box(a.cbmax + 3 * (size_t)child, hi);
        hit = kslots_slab(r, lo, hi);
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
    bool hit = false;
    if (k < a.c) {
      float lo[3], hi[3];
      load_box(a.bmin + 3 * (size_t)k, lo);
      load_box(a.bmax + 3 * (size_t)k, hi);
      hit = perray_slab(r, lo, hi);
    }
    count += put_ids(row, kx, hit, k, lane, count);
  }
  for (int j = (count < kx ? count : kx) + lane; j < a.cap; j += 32)
    row[j] = j < kx ? a.c - 1 : 0;
  if (lane == 0) {
    a.n_cand[ray] = count < a.cap ? count : a.cap;
    a.overflow[ray] = count > a.cap;
  }
}

// perray's entry order: a warp a ray, as perray_cull; the row is kept in
// order (entry, id) in the output itself.
__global__ void __launch_bounds__(RC_WARPS * 32)
    perray_entry_kernel(const PrArgs a, float* __restrict__ entry) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RC_WARPS + warp;
  if (ray >= a.n) return;
  const RayIn r = load_ray(a.o, a.d, ray, a.t_min, __ldg(a.tm + ray));
  const int kx = a.cap < a.c ? a.cap : a.c;
  int* row = a.order + (size_t)ray * a.cap;
  float* ent = entry + (size_t)ray * a.cap;
  // a NaN t_max fails hi0 >= lo0: no candidate
  const bool open = r.hi0 >= r.lo0;
  int n_all = 0, count = 0;  // candidates; the row's sorted entries
  for (int c0 = 0; open && c0 < a.c; c0 += 32) {
    const int k = c0 + lane;
    bool hit = false;
    float lo_t = INFINITY;
    if (k < a.c) {
      float lo[3], hi[3];
      load_box(a.bmin + 3 * (size_t)k, lo);
      load_box(a.bmax + 3 * (size_t)k, hi);
      hit = perray_window(r, lo, hi, &lo_t);
    }
    n_all += __popc(__ballot_sync(FULL_MASK, hit));
    unsigned fin = __ballot_sync(FULL_MASK, hit && lo_t < INFINITY);
    while (fin && kx > 0) {
      const int src = __ffs(fin) - 1;
      fin &= fin - 1u;
      const float e = __shfl_sync(FULL_MASK, lo_t, src);
      // the row holds smaller ids only: e goes after every entry <= e
      if (count == kx && !(e < ent[kx - 1])) continue;
      int p = 0;
      for (int i = lane; i < count; i += 32) p += ent[i] <= e;
      p = __reduce_add_sync(FULL_MASK, p);
      const int end = count < kx ? count : kx - 1;  // [p, end) moves down
      for (int top = end; top > p; top -= 32) {
        const int i = top - 1 - lane;
        const bool mv = i >= p;
        float ve = 0.0f;
        int vi = 0;
        if (mv) {
          ve = ent[i];
          vi = row[i];
        }
        __syncwarp();
        if (mv) {
          ent[i + 1] = ve;
          row[i + 1] = vi;
        }
        __syncwarp();
      }
      if (lane == 0) {
        ent[p] = e;
        row[p] = c0 + src;
      }
      __syncwarp();
      if (count < kx) ++count;
    }
  }
  // the ids of no finite entry, ascending, at +inf
  for (int c0 = 0, at = count; at < kx && c0 < a.c; c0 += 32) {
    const int k = c0 + lane;
    bool fin = false;
    if (open && k < a.c) {
      float lo[3], hi[3], lo_t;
      load_box(a.bmin + 3 * (size_t)k, lo);
      load_box(a.bmax + 3 * (size_t)k, hi);
      fin = perray_window(r, lo, hi, &lo_t) && lo_t < INFINITY;
    }
    const unsigned m = __ballot_sync(FULL_MASK, k < a.c && !fin);
    const int pos = at + __popc(m & ((1u << lane) - 1u));
    if (k < a.c && !fin && pos < kx) {
      row[pos] = k;
      ent[pos] = INFINITY;
    }
    at += __popc(m);
  }
  for (int j = kx + lane; j < a.cap; j += 32) {
    row[j] = 0;
    ent[j] = INFINITY;
  }
  if (lane == 0) {
    a.n_cand[ray] = n_all < a.cap ? n_all : a.cap;
    a.overflow[ray] = n_all > a.cap;
  }
}

struct PairArgs {
  const float* o;
  const float* d;
  const float* tm;
  const float* bmin;  // [C, 3]
  const float* bmax;
  int* order;         // [N, k_eff] scratch
  int* hist;          // [NT, C] scratch
  int* base;          // [C] scratch
  int* pair_ray;      // [P]
  int* tile_cluster;  // [P / T]
  int* dst;           // [N, cap]
  int* n_cand;
  unsigned char* overflow;
  int* n_tiles;       // [1]
  float t_min;
  int n, c, cap, k_eff, rt, nt, t, p_cap;
};

// 1. The cull: a thread block a ray tile, a warp a ray.
__global__ void __launch_bounds__(RC_WARPS * 32)
    pair_cull_kernel(const PairArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* h = a.hist + (size_t)blockIdx.x * a.c;
  for (int j = threadIdx.x; j < a.c; j += blockDim.x) h[j] = 0;
  __syncthreads();
  const int first = blockIdx.x * a.rt;
  const int end = min(first + a.rt, a.n);
  for (int ray = first + warp; ray < end; ray += RC_WARPS) {
    const float tm = __ldg(a.tm + ray);
    const RayIn r = load_ray(a.o, a.d, ray, a.t_min, tm);
    int* row = a.order + (size_t)ray * a.k_eff;
    int count = 0;
    // a ray whose t_max is not >= 0 (NaN included) has no candidate
    for (int c0 = 0; tm >= 0.0f && r.hi0 >= r.lo0 && c0 < a.c &&
                     count <= a.cap;
         c0 += 32) {
      const int k = c0 + lane;
      bool hit = false;
      if (k < a.c) {
        float lo[3], hi[3];
        load_box(a.bmin + 3 * (size_t)k, lo);
        load_box(a.bmax + 3 * (size_t)k, hi);
        hit = perray_slab(r, lo, hi);
      }
      count += put_ids(row, a.k_eff, hit, k, lane, count);
    }
    const bool over = count > a.cap;
    __syncwarp();  // the row is written: count <= k_eff where not over
    if (!over)
      for (int j = lane; j < count; j += 32) atomicAdd(h + row[j], 1);
    if (lane == 0) {
      a.n_cand[ray] = over ? 0 : count;
      a.overflow[ray] = over;
    }
  }
}

#define PAIR_SCAN_THREADS 1024
#define PAIR_WALK_UNROLL 8

// 2. The offsets, the segments and the tile -> cluster table: one block.
__global__ void __launch_bounds__(PAIR_SCAN_THREADS)
    pair_scan_kernel(const PairArgs a) {
  __shared__ int warp_sums[PAIR_SCAN_THREADS / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // hist's columns -> exclusive offsets down the tiles; base <- counts
  for (int c = tid; c < a.c; c += PAIR_SCAN_THREADS) {
    int run = 0;
    int t0 = 0;
    for (; t0 + PAIR_WALK_UNROLL <= a.nt; t0 += PAIR_WALK_UNROLL) {
      int v[PAIR_WALK_UNROLL];
#pragma unroll
      for (int u = 0; u < PAIR_WALK_UNROLL; ++u)
        v[u] = a.hist[(size_t)(t0 + u) * a.c + c];
#pragma unroll
      for (int u = 0; u < PAIR_WALK_UNROLL; ++u) {
        a.hist[(size_t)(t0 + u) * a.c + c] = run;
        run += v[u];
      }
    }
    for (; t0 < a.nt; ++t0) {
      const int v = a.hist[(size_t)t0 * a.c + c];
      a.hist[(size_t)t0 * a.c + c] = run;
      run += v;
    }
    a.base[c] = run;
  }
  if (tid == 0) carry = 0;
  __syncthreads();
  // base <- the exclusive scan of seg = counts rounded up to whole tiles
  for (int c0 = 0; c0 < a.c; c0 += PAIR_SCAN_THREADS) {
    const int c = c0 + tid;
    const int cnt = c < a.c ? a.base[c] : 0;
    const int seg = (cnt + a.t - 1) / a.t * a.t;
    int incl = seg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, w, off);
        if (lane >= off) w += v;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0);
    if (c < a.c) a.base[c] = before + incl - seg;
    __syncthreads();  // every thread has read carry
    if (tid == 0) carry += warp_sums[PAIR_SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) a.n_tiles[0] = min(carry, a.p_cap) / a.t;
  // tile i -> the last cluster whose base is <= i T (base ascends)
  for (int i = tid; i < a.p_cap / a.t; i += PAIR_SCAN_THREADS) {
    const int start = i * a.t;
    int lo = 0, hi = a.c;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.base[mid] <= start)
        lo = mid + 1;
      else
        hi = mid;
    }
    a.tile_cluster[i] = max(0, min(lo - 1, a.c - 1));
  }
}

// 3. The ranks, dst and the scatter: a warp a ray tile, its rays in order.
__global__ void __launch_bounds__(32) pair_rank_kernel(const PairArgs a,
                                                        int smem_offsets) {
  extern __shared__ int offsets_smem[];
  const int lane = threadIdx.x;
  int* run = a.hist + (size_t)blockIdx.x * a.c;
  if (smem_offsets) {
    for (int j = lane; j < a.c; j += 32) offsets_smem[j] = run[j];
    run = offsets_smem;
  }
  __syncwarp();
  const int first = blockIdx.x * a.rt;
  const int end = min(first + a.rt, a.n);
  for (int ray = first; ray < end; ++ray) {
    const int nc = a.n_cand[ray];
    const int* ord = a.order + (size_t)ray * a.k_eff;
    int* drow = a.dst + (size_t)ray * a.cap;
    bool past = false;
    for (int j = lane; j < a.cap; j += 32) {
      int dv = a.p_cap;
      if (j < nc) {
        const int cl = ord[j];
        const int rank = run[cl];
        run[cl] = rank + 1;
        dv = a.base[cl] + rank;
        past |= dv >= a.p_cap;
      }
      drow[j] = dv;
    }
    const bool over_budget = __any_sync(FULL_MASK, past);
    for (int j = lane; j < nc; j += 32) {  // the lanes' own slots
      if (over_budget)
        drow[j] = a.p_cap;
      else
        a.pair_ray[drow[j]] = ray;
    }
    if (lane == 0 && over_budget) {
      a.n_cand[ray] = 0;
      a.overflow[ray] = 1;
    }
    __syncwarp();  // the running offsets are written for the next ray
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

extern "C" int perray_entry(const void* o, const void* d, const void* tm,
                            float t_min, const void* bmin, const void* bmax,
                            int n, int c, int cap, void* order, void* entry,
                            void* n_cand, void* overflow, void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  const PrArgs a = {(const float*)o, (const float*)d, (const float*)tm,
                    (const float*)bmin, (const float*)bmax, (int*)order,
                    (int*)n_cand, (unsigned char*)overflow, t_min, n, c,
                    cap};
  perray_entry_kernel<<<grid_of(n), RC_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(a, (float*)entry);
  return (int)cudaGetLastError();
}

// the largest C whose running offsets pair_rank keeps in shared memory
#define PAIR_SMEM_MAX_C 12288

// The pair tables: three launches on `stream`; returns the first
// cudaError_t (0 = ok). rt rays a tile, nt = ceil(n / rt) tiles; p_cap a
// multiple of t; pair_ray filled with -1 by the caller; the caller keeps
// n * k_eff + c * t below 2^31.
extern "C" int pair_tables(const void* o, const void* d, const void* tm,
                           float t_min, const void* bmin, const void* bmax,
                           int n, int c, int cap, int rt, int t, int p_cap,
                           void* order, void* hist, void* base,
                           void* pair_ray, void* tile_cluster, void* dst,
                           void* n_cand, void* overflow, void* n_tiles,
                           void* stream) {
  const int k_eff = cap < c ? cap : c;
  if (n < 0 || c < 1 || cap < 0 || rt < 1 || t < 1 || p_cap < 0 ||
      p_cap % t)
    return (int)cudaErrorInvalidValue;
  const int nt = n > 0 ? (n + rt - 1) / rt : 0;
  const PairArgs a = {(const float*)o, (const float*)d, (const float*)tm,
                      (const float*)bmin, (const float*)bmax, (int*)order,
                      (int*)hist, (int*)base, (int*)pair_ray,
                      (int*)tile_cluster, (int*)dst, (int*)n_cand,
                      (unsigned char*)overflow, (int*)n_tiles, t_min, n, c,
                      cap, k_eff, rt, nt, t, p_cap};
  cudaStream_t s = (cudaStream_t)stream;
  if (nt > 0) {
    pair_cull_kernel<<<nt, RC_WARPS * 32, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pair_scan_kernel<<<1, PAIR_SCAN_THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nt == 0) return (int)err;
  const int smem = c <= PAIR_SMEM_MAX_C;
  pair_rank_kernel<<<nt, 32, smem ? c * sizeof(int) : 0, s>>>(a, smem);
  return (int)cudaGetLastError();
}

template <typename K>
static int occupancy(K kernel, size_t smem, int* regs, int* warps_per_sm,
                     int threads = RC_WARPS * 32) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  *warps_per_sm = blocks * threads / 32;
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

extern "C" int perray_entry_occupancy(int* regs, int* warps_per_sm) {
  return occupancy(perray_entry_kernel, 0, regs, warps_per_sm);
}

// The pair tables' three kernels (which 0, 1, 2: cull, scan, rank; the
// rank at C clusters).
extern "C" int pair_tables_occupancy(int which, int c, int* regs,
                                     int* warps_per_sm) {
  if (which == 0) return occupancy(pair_cull_kernel, 0, regs, warps_per_sm);
  if (which == 1)
    return occupancy(pair_scan_kernel, 0, regs, warps_per_sm,
                     PAIR_SCAN_THREADS);
  return occupancy(pair_rank_kernel,
                   c <= PAIR_SMEM_MAX_C ? c * sizeof(int) : 0, regs,
                   warps_per_sm, 32);
}
