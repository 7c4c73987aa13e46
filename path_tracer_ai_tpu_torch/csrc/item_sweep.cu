// Work-item Möller–Trumbore sweep of the worklist backend for Hopper
// (sm_90a).
//
// What it replaces: no Pallas kernel stands behind it; it carries the body
// of the XLA-fused path_tracer_ai_tpu/accel/worklist.py:325 `_sweep_items`
// (intersector "exact"). A work item j belongs to block item_block[j]; its
// group index is k = clamp(j - ibase[block], 0, n_groups - 1) and it tests
// the block's B = 8 rays against the G = 4 clusters order_g[block, k,
// 0..3] of S triangles each. Slot i of the item is live when k * G + i <
// n_cand[block] (the entries past it are garbage that points at C - 1) and
// its cluster id lies in [0, C). Per item and ray the result is (min t, min
// triangle id at that t) over the live slots' passing tests, or (+inf,
// INT32_MAX); for an occlusion query, whether some live slot passes.
//
// Layouts (see accel/cuda_items.py):
//   tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris): rows v0.xyz e1.xyz
//            e2.xyz, row 9 = the triangle id bit-cast to f32.
//   rays     [nb, 8, B] f32 (traverse.pack_block_rays): ox oy oz dx dy dz
//            t_max t_min.
//   item_block [i_cap] i32; ibase, n_cand [nb] i32; order_g [nb, n_groups,
//            G] i32; n_items: one i32 in device memory, the real item
//            count (the reference's traced fori_loop bound), clamped to
//            [0, i_cap] here; next_item: one i32 of scratch.
//   out_a    [i_cap, B] f32 t (closest) or u8 occluded (any hit);
//   out_b    [i_cap, B] i32 tri (closest only). Only items < n_items are
//            written; the wrapper fills the rest.
//
// What bounds it on the H100: instruction issue. The earlier design (a
// lane a (ray, cluster) pair, the item's four clusters staged in 24 KB of
// shared memory a warp, one test a thread at a time) took 10.07 / 11.89 ms
// on the worklist render's closest / shadow wave, 9.0x / 11.1x the
// operations bound (PERF.md §6, step 0, NVIDIA H100 80GB HBM3, 700
// W): its four slots' clusters lay 6,144 bytes apart, so each LDS.128 of
// a test met a 4-way bank conflict (padding them 16 bytes apart: 6.88 /
// 7.59 ms; its generic instance, 6 KB a warp at 32 warps an SM: 3.43 /
// 4.34 ms), its staging copy cost 15%, its dead rays and slots were swept,
// and a thread had one test in flight.
//
// Design: triangle-stationary. One warp an item: a persistent grid of
// one-warp thread blocks (the card's resident ones) takes the items, one
// at a time from a counter in device memory (next_item, zeroed by the
// entry point), up to the count it reads there, so that the host reads
// nothing. Items differ in cost: a fixed stride over the items (slot_sweep's
// pattern, csrc/ctiles_sweep.cu) left the last warps of a wave behind and
// took 3.97 / 3.97 ms where a thread block an item (sized on the host)
// took 3.64 / 3.54 and the counter 3.73 / 3.52 (the worklist render's two
// waves, NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_sweep_variants.py). The item's live rays
// (t_max >= t_min) are compacted, in shared memory, into R = 2, 4, 6 or 8
// places (the count rounded up to even; the padding rays pass nothing),
// and its G * S (slot, triangle) pairs are walked flat in chunks of 32:
// lane l loads the triangle of pair chunk * 32 + l straight from the
// pack's coalesced rows (ten 128-byte reads a chunk, nothing staged, so no
// bank conflict) and tests it against the R rays, read by broadcast from
// shared memory two or four at a time, their tests and reciprocals in
// flight together; the next chunk's place is found while the loads are in
// flight. A chunk whose lanes all fall on dead slots is skipped; a pair's
// slot is one division a chunk. Closest: each lane keeps R (t, tri) pairs
// and the warp folds them at the end (redux min on an order-preserving key
// of t, then on the id among the lanes at that t). Any hit: the warp ORs
// the lanes' occlusion bits after each chunk; an occluded ray leaves the
// set (the rest are compacted again, which may drop R), and the warp
// leaves once no ray is open. No test of a dead ray or slot, and none of
// an occluded ray past the chunk that occluded it, is made. One body
// serves every S: a template constant in the tuned instances (S in {2,
// 128}), a run-time value in the generic one. The new design runs at
// 3.3x the bound on both waves (PERF.md §6).
//
// Exactness: mt.cuh's arithmetic (traverse._mt_sweep's op order, the
// reciprocal with the IEEE division's bits; build with --fmad=false). The
// closest fold is the oracle's lexicographic (min t, min id at that t) rule,
// which gives the same bits in any order of the tests; the occlusion OR is
// exact whichever test finds the hit first. A cluster named twice in an
// item is tested twice and changes no result.

#include "mt.cuh"

#define PACK_ROWS 10
#define ITEM_B 8  // rays a block
#define ITEM_G 4  // clusters an item

// A ray as the warp shares it: (ox oy oz dx) (dy dz t_min t_max).
typedef float4 ItemRay[2];

// The ray of a dead slot: it passes no test (t_max < t_min).
__device__ __forceinline__ void dead_ray(float4* a, float4* b) {
  *a = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  *b = make_float4(1.0f, 1.0f, 0.0f, -1.0f);
}

// Writes the open rays (bits of `open`; lane r < B holds ray r in a, b) to
// rs[0 .. n), n = popc(open), in ray order, and dead rays to rs[n .. B).
// Returns the lane's place among the open rays (-1 if its ray is not
// open).
__device__ __forceinline__ int compact_rays(ItemRay* rs, float4 a, float4 b,
                                            unsigned open, int lane) {
  __syncwarp();  // every lane is done reading the last compaction
  const int n = __popc(open);
  int pos = -1;
  if (lane < ITEM_B && ((open >> lane) & 1u)) {
    pos = __popc(open & ((1u << lane) - 1u));
    rs[pos][0] = a;
    rs[pos][1] = b;
  }
  if (lane >= n && lane < ITEM_B) {
    float4 da, db;
    dead_ray(&da, &db);
    rs[lane][0] = da;
    rs[lane][1] = db;
  }
  __syncwarp();
  return pos;
}

template <int R>
__device__ __forceinline__ void load_item_rays(const ItemRay* rs, Ray* ray,
                                               float* tmin, float* tmax) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 a = rs[r][0];
    const float4 b = rs[r][1];
    ray[r] = {a.x, a.y, a.z, a.w, b.x, b.y};
    tmin[r] = b.z;
    tmax[r] = b.w;
  }
}

// The first chunk c' >= c with a lane on a live slot (n_chunks if none),
// and the lane's triangle in it: *p points at row 0 of its column of the
// pack, or is null for a lane on a dead slot or past the item's G * S
// pairs. One division a chunk (a shift or a multiply where S is a
// template constant).
template <int S_T>
__device__ __forceinline__ int next_chunk(int c, int n_chunks, int s,
                                          unsigned slots, int cid_lane,
                                          int lane,
                                          const float* __restrict__ pack,
                                          const float** p) {
  for (; c < n_chunks; ++c) {
    const int f = c * 32 + lane;
    const int slot = (S_T > 0 ? f / S_T : f / s);
    const int j = f - slot * s;
    const bool valid = slot < ITEM_G && ((slots >> slot) & 1u);
    const int ci = __shfl_sync(FULL_MASK, cid_lane, slot & (ITEM_G - 1));
    if (__any_sync(FULL_MASK, valid)) {
      *p = valid ? pack + (size_t)ci * PACK_ROWS * s + j : nullptr;
      return c;
    }
  }
  *p = nullptr;
  return n_chunks;
}

// One triangle (tr, id tid) against R rays (ray[r], window [tmin[r],
// tmax[r]]): mt.cuh's parts for all R, their reciprocals in flight
// together (the IEEE division for all of them where some determinant is
// 2^126 or more), v and t skipped where no lane of the warp has 0 <= u <= 1
// for any of its rays. Returns the bits of the rays that pass; with
// CLOSEST, folds each pass into (best_t[r], best_tri[r]) by the
// lexicographic rule.
template <int R, bool CLOSEST>
__device__ __forceinline__ unsigned mt_rays(const Tri& tr, int tid,
                                            const Ray* ray, const float* tmin,
                                            const float* tmax, float* best_t,
                                            int* best_tri) {
  Vec3 h[R], sv[R];
  float x[R], f[R], u[R];
  bool ok[R];
  bool fast = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float det = mt_det(ray[r], tr, &h[r]);
    ok[r] = fabsf(det) > MT_EPSILON;
    x[r] = ok[r] ? det : 1.0f;
    fast = fast && fabsf(x[r]) < RCP_FAST_BELOW;
  }
  if (fast) {
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = rcp_fast(x[r]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = 1.0f / x[r];
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    u[r] = mt_u(ray[r], tr, h[r], f[r], &sv[r]);
    ok[r] = ok[r] && (u[r] >= 0.0f) && (u[r] <= 1.0f);
    any = any || ok[r];
  }
  if (!__any_sync(FULL_MASK, any)) return 0u;
  unsigned bits = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t;
    const bool pass =
        mt_vt(ray[r], tr, sv[r], f[r], u[r], ok[r], tmin[r], tmax[r], &t);
    if constexpr (CLOSEST) {
      if (pass) fold_min_tri(t, tid, &best_t[r], &best_tri[r]);
    }
    bits |= (pass ? 1u : 0u) << r;
  }
  return bits;
}

// One triangle against the R compacted rays of rs, G at a time (4 where R
// is a multiple of 4, else 2), each group read from shared memory for it:
// the rays' 8R floats would hold an SM to twelve warps, the G in flight
// to twenty. Returns the bits of the rays that pass; with CLOSEST, folds
// each pass into (best_t[r], best_tri[r]).
template <int R, bool CLOSEST>
__device__ __forceinline__ unsigned test_rays(const Tri& tr, int tid,
                                              const ItemRay* rs,
                                              float* best_t, int* best_tri) {
  constexpr int G = (R % 4 == 0) ? 4 : 2;
  unsigned bits = 0u;
#pragma unroll
  for (int g = 0; g < R; g += G) {
    Ray ray[G];
    float tmin[G], tmax[G];
    load_item_rays<G>(rs + g, ray, tmin, tmax);
    bits |= mt_rays<G, CLOSEST>(tr, tid, ray, tmin, tmax,
                                CLOSEST ? best_t + g : nullptr,
                                CLOSEST ? best_tri + g : nullptr)
            << g;
  }
  return bits;
}

// Closest hit of the R compacted rays (rs) over the item's live chunks;
// lane r < B then writes ray r's row: the result of compacted ray `pos`,
// or (inf, INT32_MAX) where pos < 0.
template <int R, int S_T>
__device__ __forceinline__ void closest_walk(
    const float* __restrict__ pack, int s, unsigned slots, int cid_lane,
    const ItemRay* rs, int lane, int pos, float* out_t, int* out_tri) {
  float best_t[R];
  int best_tri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = INFINITY;
    best_tri[r] = I32_MAX;
  }
  const int n_chunks = (ITEM_G * s + 31) / 32;
  const float* p;
  int c = next_chunk<S_T>(0, n_chunks, s, slots, cid_lane, lane, pack, &p);
#pragma unroll 1
  while (c < n_chunks) {
    int tid;
    const Tri tr = load_column_or_zero(p, s, &tid);
    c = next_chunk<S_T>(c + 1, n_chunks, s, slots, cid_lane, lane, pack, &p);
    test_rays<R, true>(tr, tid, rs, best_t, best_tri);
  }
  float t_out = INFINITY;
  int tri_out = I32_MAX;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float t = key_float(__reduce_min_sync(FULL_MASK,
                                                order_key(best_t[r])));
    const int tri =
        __reduce_min_sync(FULL_MASK, best_t[r] == t ? best_tri[r] : I32_MAX);
    if (pos == r) {
      t_out = t;
      tri_out = tri;
    }
  }
  if (lane < ITEM_B) {
    out_t[lane] = t_out;
    out_tri[lane] = tri_out;
  }
}

// Any hit of the R compacted rays from chunk c on, until some ray passes:
// *hit = the compacted rays that passed in that chunk (0 if none did to
// the end); returns the chunk to go on from.
template <int R, int S_T>
__device__ __forceinline__ int anyhit_walk(const float* __restrict__ pack,
                                           int s, unsigned slots,
                                           int cid_lane, const ItemRay* rs,
                                           int lane, int c, unsigned* hit) {
  const int n_chunks = (ITEM_G * s + 31) / 32;
  const float* p;
  c = next_chunk<S_T>(c, n_chunks, s, slots, cid_lane, lane, pack, &p);
#pragma unroll 1
  while (c < n_chunks) {
    int tid;
    const Tri tr = load_column_or_zero(p, s, &tid);
    c = next_chunk<S_T>(c + 1, n_chunks, s, slots, cid_lane, lane, pack, &p);
    const unsigned h = __reduce_or_sync(
        FULL_MASK, test_rays<R, false>(tr, tid, rs, nullptr, nullptr));
    if (h != 0u) {
      *hit = h;
      return c;
    }
  }
  *hit = 0u;
  return n_chunks;
}

// The warp's next item, from the counter (lane 0 takes it).
__device__ __forceinline__ int grab_item(int* next_item, int lane) {
  const int v = lane == 0 ? atomicAdd(next_item, 1) : 0;
  return __shfl_sync(FULL_MASK, v, 0);
}

// S_T: S as a template constant, or 0 for S = s at run time.
template <int S_T, bool CLOSEST>
__global__ void __launch_bounds__(32)
    item_sweep_kernel(const float* __restrict__ tri_pack,
                      const float* __restrict__ rays,
                      const int* __restrict__ item_block,
                      const int* __restrict__ ibase,
                      const int* __restrict__ order_g,
                      const int* __restrict__ n_cand, void* __restrict__ out_a,
                      int* __restrict__ out_b,
                      const int* __restrict__ n_items_dev, int i_cap,
                      int n_groups, int n_clusters, int s_run,
                      int* __restrict__ next_item) {
  __shared__ ItemRay rs[ITEM_B];
  const int s = S_T > 0 ? S_T : s_run;
  const int lane = threadIdx.x;
  const int n_live = *n_items_dev;
  const int n_items = n_live < 0 ? 0 : (n_live < i_cap ? n_live : i_cap);
  // compact_rays' first __syncwarp keeps an item's writes of rs after the
  // last item's reads
  for (int item = grab_item(next_item, lane); item < n_items;
       item = grab_item(next_item, lane)) {
    const int blk = item_block[item];
    int k = item - ibase[blk];
    k = k < 0 ? 0 : (k > n_groups - 1 ? n_groups - 1 : k);
    int cid = 0;
    bool slot_live = false;
    if (lane < ITEM_G) {
      cid = order_g[((size_t)blk * n_groups + k) * ITEM_G + lane];
      slot_live = k * ITEM_G + lane < n_cand[blk] && cid >= 0 &&
                  cid < n_clusters;
    }
    const unsigned slots = __ballot_sync(FULL_MASK, slot_live);

    float4 ra, rb;
    dead_ray(&ra, &rb);
    if (lane < ITEM_B) {
      const float* rp = rays + (size_t)blk * RAY_ROWS * ITEM_B + lane;
      ra = make_float4(rp[0 * ITEM_B], rp[1 * ITEM_B], rp[2 * ITEM_B],
                       rp[3 * ITEM_B]);
      rb = make_float4(rp[4 * ITEM_B], rp[5 * ITEM_B], rp[7 * ITEM_B],
                       rp[6 * ITEM_B]);
    }
    unsigned open = __ballot_sync(FULL_MASK, lane < ITEM_B && rb.w >= rb.z);
    if (slots == 0u) open = 0u;

    const size_t row = (size_t)item * ITEM_B;
    if constexpr (CLOSEST) {
      float* out_t = reinterpret_cast<float*>(out_a) + row;
      int* out_tri = out_b + row;
      const int pos = compact_rays(rs, ra, rb, open, lane);
      switch ((__popc(open) + 1) >> 1) {
        case 1:
          closest_walk<2, S_T>(tri_pack, s, slots, cid, rs, lane, pos, out_t,
                               out_tri);
          break;
        case 2:
          closest_walk<4, S_T>(tri_pack, s, slots, cid, rs, lane, pos, out_t,
                               out_tri);
          break;
        case 3:
          closest_walk<6, S_T>(tri_pack, s, slots, cid, rs, lane, pos, out_t,
                               out_tri);
          break;
        case 4:
          closest_walk<8, S_T>(tri_pack, s, slots, cid, rs, lane, pos, out_t,
                               out_tri);
          break;
        default:  // no open ray: every row a miss
          if (lane < ITEM_B) {
            out_t[lane] = INFINITY;
            out_tri[lane] = I32_MAX;
          }
      }
    } else {
      const int n_chunks = (ITEM_G * s + 31) / 32;
      unsigned occ = 0u;
      int c = 0;
      while (open != 0u && c < n_chunks) {
        const int pos = compact_rays(rs, ra, rb, open, lane);
        unsigned hit = 0u;
        switch ((__popc(open) + 1) >> 1) {
          case 1:
            c = anyhit_walk<2, S_T>(tri_pack, s, slots, cid, rs, lane, c, &hit);
            break;
          case 2:
            c = anyhit_walk<4, S_T>(tri_pack, s, slots, cid, rs, lane, c, &hit);
            break;
          case 3:
            c = anyhit_walk<6, S_T>(tri_pack, s, slots, cid, rs, lane, c, &hit);
            break;
          default:
            c = anyhit_walk<8, S_T>(tri_pack, s, slots, cid, rs, lane, c, &hit);
        }
        const unsigned newly =
            __ballot_sync(FULL_MASK, pos >= 0 && ((hit >> pos) & 1u));
        occ |= newly;
        open &= ~newly;
        if (hit == 0u) break;  // walked to the end
      }
      if (lane < ITEM_B) {
        reinterpret_cast<unsigned char*>(out_a)[row + lane] = (occ >> lane) & 1u;
      }
    }
  }
}

// The card's resident one-warp blocks of the instance (at least one),
// capped at i_cap: a persistent grid that takes the items from a counter.
template <int S_T, bool CLOSEST>
static int item_blocks(int i_cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, item_sweep_kernel<S_T, CLOSEST>, 32, 0);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(i_cap < resident ? i_cap : resident);
}

template <int S_T, bool CLOSEST>
static int launch(const void* tri_pack, const void* rays,
                  const void* item_block, const void* ibase,
                  const void* order_g, const void* n_cand, void* out_a,
                  void* out_b, const void* n_items, int i_cap, int n_groups,
                  int n_clusters, int s, cudaStream_t stream, void* next) {
  const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  item_sweep_kernel<S_T, CLOSEST>
      <<<item_blocks<S_T, CLOSEST>(i_cap), 32, 0, stream>>>(
          (const float*)tri_pack, (const float*)rays, (const int*)item_block,
          (const int*)ibase, (const int*)order_g, (const int*)n_cand, out_a,
          (int*)out_b, (const int*)n_items, i_cap, n_groups, n_clusters, s,
          (int*)next);
  return (int)cudaGetLastError();
}

template <int S_T, bool CLOSEST>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, item_sweep_kernel<S_T, CLOSEST>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, item_sweep_kernel<S_T, CLOSEST>, 32, 0);
  *warps_per_sm = blocks;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_ITEM_INSTANCES(CALL) CALL(2) CALL(128)

// Launches on `stream` over items [0, min(*n_items, i_cap)), the count
// read on the device: a persistent grid of one-warp thread blocks that
// take the items from next_item (one i32 of scratch, zeroed here first).
// Returns the cudaError_t of the launch (0 = ok), or NO_INSTANCE for a
// shape that is not compiled (S in {2, 128}, B = 8, G = 4).
extern "C" int item_sweep(const void* tri_pack, const void* rays,
                          const void* item_block, const void* ibase,
                          const void* order_g, const void* n_cand, void* out_a,
                          void* out_b, const void* n_items, int i_cap,
                          int n_groups, int b, int s, int n_clusters,
                          int closest, void* next_item, void* stream) {
  if (i_cap <= 0) return 0;
  if (b != ITEM_B || n_groups < 1) return NO_INSTANCE;
#define LAUNCH(S_)                                                          \
  if (s == S_)                                                              \
    return closest ? launch<S_, true>(tri_pack, rays, item_block, ibase,    \
                                      order_g, n_cand, out_a, out_b,        \
                                      n_items, i_cap, n_groups, n_clusters, \
                                      s, (cudaStream_t)stream, next_item)   \
                   : launch<S_, false>(tri_pack, rays, item_block, ibase,   \
                                       order_g, n_cand, out_a, out_b,       \
                                       n_items, i_cap, n_groups,            \
                                       n_clusters, s, (cudaStream_t)stream, \
                                       next_item);
  FOR_ITEM_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, closest) instance and the warps an SM
// holds of it (S = 0: the generic instance).
extern "C" int item_sweep_occupancy(int s, int closest, int* regs,
                                    int* warps_per_sm) {
#define OCCUPANCY(S_)                                            \
  if (s == S_)                                                   \
    return closest ? occupancy<S_, true>(regs, warps_per_sm)     \
                   : occupancy<S_, false>(regs, warps_per_sm);
  FOR_ITEM_INSTANCES(OCCUPANCY)
  OCCUPANCY(0)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// item_sweep's generic instance, with its arguments, for any S >= 1 (B = 8,
// G = 4; NO_INSTANCE for another B): the same body with S at run time.
extern "C" int item_sweep_generic(const void* tri_pack, const void* rays,
                                  const void* item_block, const void* ibase,
                                  const void* order_g, const void* n_cand,
                                  void* out_a, void* out_b,
                                  const void* n_items, int i_cap,
                                  int n_groups, int b, int s, int n_clusters,
                                  int closest, void* next_item, void* stream) {
  if (i_cap <= 0) return 0;
  if (b != ITEM_B || n_groups < 1) return NO_INSTANCE;
  if (s < 1) return (int)cudaErrorInvalidValue;
  return closest ? launch<0, true>(tri_pack, rays, item_block, ibase, order_g,
                                   n_cand, out_a, out_b, n_items, i_cap,
                                   n_groups, n_clusters, s,
                                   (cudaStream_t)stream, next_item)
                 : launch<0, false>(tri_pack, rays, item_block, ibase,
                                    order_g, n_cand, out_a, out_b, n_items,
                                    i_cap, n_groups, n_clusters, s,
                                    (cudaStream_t)stream, next_item);
}
