// Work-item Möller–Trumbore sweep of the worklist backend for Hopper
// (sm_90a).
//
// No Pallas kernel stands behind it: it carries the body of the XLA-fused
// path_tracer_ai_tpu/accel/worklist.py `_sweep_items` (intersector
// "exact"). A work item j belongs to block item_block[j]; its group index
// is k = clamp(j - ibase[block], 0, n_groups - 1) and it tests the block's
// B = 8 rays against the G = 4 clusters order_g[block, k, 0..3] of S
// triangles each. Slot i of the item is live when k * G + i < n_cand[block].
// Per item and ray the result is (min t, min triangle id at that t) over
// the live slots' passing tests, or (+inf, INT32_MAX); for an occlusion
// query, whether some live slot passes.
//
// Layouts (see accel/cuda_items.py):
//   tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris): rows v0.xyz e1.xyz
//            e2.xyz, row 9 = the triangle id bit-cast to f32.
//   rays     [nb, 8, B] f32 (traverse.pack_block_rays): ox oy oz dx dy dz
//            t_max t_min.
//   item_block [i_cap] i32; ibase, n_cand [nb] i32; order_g [nb, n_groups,
//            G] i32.
//   out_a    [i_cap, B] f32 t (closest) or u8 occluded (any hit);
//   out_b    [i_cap, B] i32 tri (closest only). Only items < n_items are
//            written; the wrapper fills the rest.
//
// Design (simple first). One warp an item; lane = ray * G + slot, so each
// lane tests one ray against one cluster: the warp stages the item's live
// clusters transposed into its own shared memory (mt.cuh
// stage_cluster_warp, 4 * S * 48 bytes, 24 KB at S = 128) and every lane
// walks its cluster's S triangles with mt.cuh's closest loop (sweep_run,
// one ray a thread) or, where S is a multiple of 32, its any-hit loop
// (anyhit_run, which leaves once every lane is occluded or dead). The four
// lanes of a ray then fold by shuffles: the lexicographic (t, tri) minimum
// or an OR. A lane whose slot is past n_cand, or whose ray is dead, goes in
// with t_max = -1 and passes nothing; a warp with no live lane stages
// nothing. tile_sweep cannot carry items: its T >= 64 lanes a cluster
// against B = 8 rays an item would leave 7/8 of every tile empty.
//
// What bounds it: the shared-memory staging (24 KB a warp) holds an SM to
// nine resident warps, too few to hide the copy and the test's latency;
// the tests' instruction issue is the floor (see mt.cuh). Items are
// ordered by block, so a block's items run on neighbouring warps and its
// rays come from L1/L2.
//
// Exactness: mt.cuh's arithmetic (traverse._mt_sweep's op order, the
// reciprocal with the IEEE division's bits; build with --fmad=false), and
// the fold is the oracle's lexicographic rule, the reference's
// min t / min tri at t. The any-hit lane result OR is exact whichever test
// finds the hit first.

#include "mt.cuh"

#define PACK_ROWS 10
#define ITEM_B 8  // rays a block
#define ITEM_G 4  // clusters an item

template <int S>
constexpr size_t item_smem_bytes() {
  static_assert(ITEM_G * S * sizeof(TriRec) <= 48 * 1024,
                "an item's clusters exceed the default shared memory");
  return ITEM_G * S * sizeof(TriRec);
}

template <int S, bool CLOSEST>
__global__ void __launch_bounds__(32)
    item_sweep_kernel(const float* __restrict__ tri_pack,
                      const float* __restrict__ rays,
                      const int* __restrict__ item_block,
                      const int* __restrict__ ibase,
                      const int* __restrict__ order_g,
                      const int* __restrict__ n_cand, void* __restrict__ out_a,
                      int* __restrict__ out_b, int n_items, int n_groups,
                      int n_clusters) {
  extern __shared__ __align__(16) unsigned char smem[];
  TriRec* buf = reinterpret_cast<TriRec*>(smem);
  const int lane = threadIdx.x;
  const int item = blockIdx.x;
  if (item >= n_items) return;
  const int r = lane / ITEM_G, slot = lane % ITEM_G;

  const int blk = item_block[item];
  int k = item - ibase[blk];
  k = k < 0 ? 0 : (k > n_groups - 1 ? n_groups - 1 : k);
  const int cid = order_g[((size_t)blk * n_groups + k) * ITEM_G + slot];
  const bool slot_live = k * ITEM_G + slot < n_cand[blk] && cid >= 0 &&
                         cid < n_clusters;

  const float* rp = rays + (size_t)blk * RAY_ROWS * ITEM_B + r;
  const Ray ray = load_ray(rp, ITEM_B);
  const float tmin = rp[7 * ITEM_B];
  const float tmax = slot_live ? rp[6 * ITEM_B] : -1.0f;
  const bool dead = !(tmax >= tmin);

  // Stage the clusters of the slots that have a live lane, each one by the
  // whole warp. A warp with no live lane stages nothing and writes misses.
  const unsigned live_lanes = __ballot_sync(FULL_MASK, !dead);
  if (live_lanes != 0u) {
#pragma unroll
    for (int i = 0; i < ITEM_G; ++i) {
      const int ci = __shfl_sync(FULL_MASK, cid, i);  // lane i: ray 0, slot i
      unsigned slot_lanes = 0u;
#pragma unroll
      for (int rr = 0; rr < ITEM_B; ++rr) slot_lanes |= 1u << (rr * ITEM_G + i);
      if (live_lanes & slot_lanes) {
        stage_cluster_warp<S>(buf + i * S,
                              tri_pack + (size_t)ci * PACK_ROWS * S, lane);
      }
    }
    cp_async_wait_all();
    __syncwarp();
  }
  const TriRec* tri = buf + slot * S;

  if constexpr (CLOSEST) {
    float best_t = INFINITY;
    int best_tri = I32_MAX;
    if (live_lanes != 0u) {
      sweep_run<1, S>(tri, &ray, &tmin, &tmax, &best_t, &best_tri);
    }
#pragma unroll
    for (int off = ITEM_G / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(FULL_MASK, best_t, off);
      const int otri = __shfl_xor_sync(FULL_MASK, best_tri, off);
      if (ot < best_t || (ot == best_t && otri < best_tri)) {
        best_t = ot;
        best_tri = otri;
      }
    }
    if (slot == 0) {
      reinterpret_cast<float*>(out_a)[(size_t)item * ITEM_B + r] = best_t;
      out_b[(size_t)item * ITEM_B + r] = best_tri;
    }
  } else {
    bool occ = false;
    if (live_lanes != 0u) {
      if constexpr (S % ANYHIT_VOTE_EVERY == 0) {
        occ = anyhit_run<S>(tri, ray, tmin, tmax, dead, false);
      } else {
        float best_t = INFINITY;
        int best_tri = I32_MAX;
        sweep_run<1, S>(tri, &ray, &tmin, &tmax, &best_t, &best_tri);
        occ = best_tri != I32_MAX;
      }
    }
    const unsigned votes = __ballot_sync(FULL_MASK, occ);
    if (slot == 0) {
      const unsigned mine = (votes >> (r * ITEM_G)) & ((1u << ITEM_G) - 1u);
      reinterpret_cast<unsigned char*>(out_a)[(size_t)item * ITEM_B + r] =
          mine != 0u;
    }
  }
}

template <int S, bool CLOSEST>
static int launch(const void* tri_pack, const void* rays,
                  const void* item_block, const void* ibase,
                  const void* order_g, const void* n_cand, void* out_a,
                  void* out_b, int n_items, int n_groups, int n_clusters,
                  cudaStream_t stream) {
  item_sweep_kernel<S, CLOSEST><<<n_items, 32, item_smem_bytes<S>(), stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)item_block,
      (const int*)ibase, (const int*)order_g, (const int*)n_cand, out_a,
      (int*)out_b, n_items, n_groups, n_clusters);
  return (int)cudaGetLastError();
}

template <int S, bool CLOSEST>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, item_sweep_kernel<S, CLOSEST>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, item_sweep_kernel<S, CLOSEST>, 32, item_smem_bytes<S>());
  *warps_per_sm = blocks;
  return (int)err;
}

// The generic instance (mt.cuh CHUNK): S >= 1 at run time. The warp stages
// the item's live clusters 32 triangles at a time (4 x 32 TriRecs, 6 KB;
// zeros past S), and each lane sweeps its cluster's chunk with the tuned
// instances' loops (sweep_run<1, 32>, or anyhit_run<32> for an occlusion
// query, which leaves once every lane is occluded or dead). The fold and the
// writes are the tuned kernel's.
template <bool CLOSEST>
__global__ void __launch_bounds__(32)
    item_sweep_generic_kernel(const float* __restrict__ tri_pack,
                              const float* __restrict__ rays,
                              const int* __restrict__ item_block,
                              const int* __restrict__ ibase,
                              const int* __restrict__ order_g,
                              const int* __restrict__ n_cand,
                              void* __restrict__ out_a,
                              int* __restrict__ out_b, int n_items,
                              int n_groups, int n_clusters, int s) {
  __shared__ TriRec buf[ITEM_G * CHUNK];
  const int lane = threadIdx.x;
  const int item = blockIdx.x;
  if (item >= n_items) return;
  const int r = lane / ITEM_G, slot = lane % ITEM_G;

  const int blk = item_block[item];
  int k = item - ibase[blk];
  k = k < 0 ? 0 : (k > n_groups - 1 ? n_groups - 1 : k);
  const int cid = order_g[((size_t)blk * n_groups + k) * ITEM_G + slot];
  const bool slot_live = k * ITEM_G + slot < n_cand[blk] && cid >= 0 &&
                         cid < n_clusters;

  const float* rp = rays + (size_t)blk * RAY_ROWS * ITEM_B + r;
  const Ray ray = load_ray(rp, ITEM_B);
  const float tmin = rp[7 * ITEM_B];
  const float tmax = slot_live ? rp[6 * ITEM_B] : -1.0f;
  const bool dead = !(tmax >= tmin);

  float best_t = INFINITY;
  int best_tri = I32_MAX;
  bool occ = false;
  const unsigned live_lanes = __ballot_sync(FULL_MASK, !dead);
#pragma unroll 1
  for (int c0 = 0; live_lanes != 0u && c0 < s; c0 += CHUNK) {
    if (!CLOSEST && __all_sync(FULL_MASK, occ || dead)) break;
#pragma unroll
    for (int i = 0; i < ITEM_G; ++i) {
      const int ci = __shfl_sync(FULL_MASK, cid, i);  // lane i: ray 0, slot i
      unsigned slot_lanes = 0u;
#pragma unroll
      for (int rr = 0; rr < ITEM_B; ++rr) slot_lanes |= 1u << (rr * ITEM_G + i);
      if (live_lanes & slot_lanes) {
        stage_chunk_warp<PACK_ROWS>(buf + i * CHUNK,
                                    tri_pack + (size_t)ci * PACK_ROWS * s, s,
                                    c0, lane);
      }
    }
    cp_async_wait_all();
    __syncwarp();
    const TriRec* tri = buf + slot * CHUNK;
    if constexpr (CLOSEST) {
      sweep_run<1, CHUNK>(tri, &ray, &tmin, &tmax, &best_t, &best_tri);
    } else {
      occ = anyhit_run<CHUNK>(tri, ray, tmin, tmax, dead, occ);
    }
    __syncwarp();  // every lane is done with the buffer
  }

  if constexpr (CLOSEST) {
#pragma unroll
    for (int off = ITEM_G / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(FULL_MASK, best_t, off);
      const int otri = __shfl_xor_sync(FULL_MASK, best_tri, off);
      if (ot < best_t || (ot == best_t && otri < best_tri)) {
        best_t = ot;
        best_tri = otri;
      }
    }
    if (slot == 0) {
      reinterpret_cast<float*>(out_a)[(size_t)item * ITEM_B + r] = best_t;
      out_b[(size_t)item * ITEM_B + r] = best_tri;
    }
  } else {
    const unsigned votes = __ballot_sync(FULL_MASK, occ);
    if (slot == 0) {
      const unsigned mine = (votes >> (r * ITEM_G)) & ((1u << ITEM_G) - 1u);
      reinterpret_cast<unsigned char*>(out_a)[(size_t)item * ITEM_B + r] =
          mine != 0u;
    }
  }
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_ITEM_INSTANCES(CALL) CALL(2) CALL(128)

// Launches on `stream` over items [0, n_items): one thread block (one warp)
// an item. Returns the cudaError_t of the launch (0 = ok), or NO_INSTANCE
// for a shape that is not compiled (S in {2, 128}, B = 8, G = 4).
extern "C" int item_sweep(const void* tri_pack, const void* rays,
                          const void* item_block, const void* ibase,
                          const void* order_g, const void* n_cand, void* out_a,
                          void* out_b, int n_items, int n_groups, int b, int s,
                          int n_clusters, int closest, void* stream) {
  if (n_items <= 0) return 0;
  if (b != ITEM_B || n_groups < 1) return NO_INSTANCE;
#define LAUNCH(S_)                                                          \
  if (s == S_)                                                              \
    return closest ? launch<S_, true>(tri_pack, rays, item_block, ibase,    \
                                      order_g, n_cand, out_a, out_b,        \
                                      n_items, n_groups, n_clusters,        \
                                      (cudaStream_t)stream)                 \
                   : launch<S_, false>(tri_pack, rays, item_block, ibase,   \
                                       order_g, n_cand, out_a, out_b,       \
                                       n_items, n_groups, n_clusters,       \
                                       (cudaStream_t)stream);
  FOR_ITEM_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, closest) instance and the warps an SM
// holds of it.
extern "C" int item_sweep_occupancy(int s, int closest, int* regs,
                                    int* warps_per_sm) {
#define OCCUPANCY(S_)                                            \
  if (s == S_)                                                   \
    return closest ? occupancy<S_, true>(regs, warps_per_sm)     \
                   : occupancy<S_, false>(regs, warps_per_sm);
  FOR_ITEM_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// item_sweep's generic instance, with its arguments, for any S >= 1 (B = 8,
// G = 4; NO_INSTANCE for another B).
extern "C" int item_sweep_generic(const void* tri_pack, const void* rays,
                                  const void* item_block, const void* ibase,
                                  const void* order_g, const void* n_cand,
                                  void* out_a, void* out_b, int n_items,
                                  int n_groups, int b, int s, int n_clusters,
                                  int closest, void* stream) {
  if (n_items <= 0) return 0;
  if (b != ITEM_B || n_groups < 1) return NO_INSTANCE;
  if (s < 1) return (int)cudaErrorInvalidValue;
#define LAUNCH(C_)                                                        \
  item_sweep_generic_kernel<C_><<<n_items, 32, 0, (cudaStream_t)stream>>>( \
      (const float*)tri_pack, (const float*)rays, (const int*)item_block,  \
      (const int*)ibase, (const int*)order_g, (const int*)n_cand, out_a,   \
      (int*)out_b, n_items, n_groups, n_clusters, s);
  if (closest) {
    LAUNCH(true)
  } else {
    LAUNCH(false)
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
