// Cluster-tile Möller–Trumbore sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_ai_tpu/accel/pallas_ctiles.py
// `tile_sweep` (`_sweep_kernel`, `_mt_rows`). Each tile of T rays is tested
// against the S triangles of each of its G clusters and reduces, per ray,
// to (best t, min triangle id at best t), or (+inf, INT32_MAX) on a miss.
// G = 1 on the closest path and in the overflow fallback; the shadow
// cascade hands over an iteration's G candidates at once. The fold is a
// lexicographic minimum, so G clusters in one launch equal G launches
// combined with cuda_ctiles.combine_min_tri.
//
// Layouts (see accel/cuda_ctiles.py):
//   tri_pack [C, 10, S] f32: rows 0-8 = v0.xyz, e1.xyz, e2.xyz; row 9 =
//            the global triangle id, bit-cast to f32 (-1 = padding slot).
//   rays     [nt, 8, T] f32: rows ox oy oz dx dy dz t_max t_min.
//   tile_cid [nt, G] i32 cluster ids per tile; an id outside [0, C) is
//            skipped.
//   t_out    [nt, T] f32, tri_out [nt, T] i32.
//   The options (ctiles_sweep_options, below) read the [C, 16, S] pack
//   (sub_skip) or its [C, S, 16] transpose (pack_t).
//
// Design (the inner loop is mt.cuh's, shared with fused_closest.cu). One
// warp per 32 R lanes of a tile, R rays per thread in registers (4 at
// T = 128, one warp a tile; 1 at T = 64 and 256, two and eight warps a
// tile: the cascade's launches are small, 1,400 tiles on average, and fill
// the card better with more warps), four warps a thread block that share
// nothing, so there is no __syncthreads. S (128, 256), T (64, 128, 256) and
// R are template parameters: the triangle loop unrolls and every
// shared-memory address is an immediate. The warp stages
// each of its G clusters transposed (12 words a triangle, 12 KB at S = 256)
// with cp.async and walks it; other warps of the SM cover the copy. A slot
// of 32 lanes that are all dead is not walked, and a warp with no live lane
// stages nothing. The TPU kernel's 8-tile groups exist only because Mosaic
// needs (8, 128) output blocks; here each tile loads its own cluster ids.
// One buffer per warp: a second one, with cluster g + 1 copied while
// cluster g is tested, halves the resident warps and hides nothing that
// they do not (measured, PERF.md).
//
// What bounds it: instruction issue, not memory. Per tile and cluster the
// warp reads 40 * S bytes (mostly from L2) for 32 * R * S tests of about 70
// instructions each; see mt.cuh for why --fmad=false puts the floor at
// about twice the operations term of the bound.
//
// Exactness. The arithmetic is mt.cuh's sweep_run (traverse._mt_sweep's
// op order; the reciprocal has the IEEE division's bits, see rcp_fast; build
// with --fmad=false). Dead lanes (t_max = -1)
// fail every test through t <= t_max; padding triangles (all zero) fail
// |a| > MT_EPSILON. The fold is the oracle's lexicographic rule
// (mt.cuh fold_min_tri); the any-hit reading `tri != INT32_MAX` relies on a
// passing test with t = +inf still setting tri.
//
// The first-slot instance (ctiles_sweep_first; FIRST = true) is the same
// kernel with the packet cascade's tie rule in place of the oracle's: it
// carries the sweep of path_tracer_ai_tpu/accel/traverse.py
// `closest_hit_packets` (traverse.py:823-845, XLA-fused there, no Pallas
// kernel), which keeps the FIRST slot at the minimum t, slots counted
// cluster i of the tile's G, then triangle j of the cluster (jnp.argmin).
// Each lane meets its slots in that order (the G clusters in turn, each
// cluster's triangles in order, whatever the unroll), so a strict
// t < best_t update keeps the first; the lanes never share a reduction.
// On a miss it writes (+inf, INT32_MAX), and a pass with t = +inf changes
// nothing (the cascade replaces its best only on ct < best). Tuned for the
// cascade's shapes: (T 64, S 128), every overflow fallback at blocks of 64,
// and (T 256, S 128), the "packets" backend's default blocks; G = 8 comes
// at run time.

#include "mt.cuh"

#define PACK_ROWS 10
#define MODE_SUB_SKIP 1
#define MODE_PACK_T 2
#define MODE_FIRST 3  // the [C, 10, S] pack, first slot (see the header)
#define PACK16_ROWS 16

__device__ __forceinline__ void cp_async_bytes16(void* dst_shared,
                                                 const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_bytes8(void* dst_shared,
                                                const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// One warp starts the copy of a [S, 16] cluster's words 0-9 of each
// triangle into S TriRecs. The caller waits and __syncwarp()s.
template <int S>
__device__ __forceinline__ void stage_cluster_rows_warp(TriRec* dst,
                                                        const float* cluster,
                                                        int lane) {
#pragma unroll
  for (int j = lane; j < S; j += 32) {
    const float* src = cluster + (size_t)j * PACK16_ROWS;
    cp_async_bytes16(&dst[j].a, src);
    cp_async_bytes16(&dst[j].b, src + 4);
    cp_async_bytes8(&dst[j].c, src + 8);
  }
}

// As stage_chunk_warp for the [s, 16] cluster of a pack_t pack.
__device__ __forceinline__ void stage_chunk_rows16_warp(TriRec* dst,
                                                        const float* cluster,
                                                        int s, int c0,
                                                        int lane) {
  const int j = c0 + lane;
  if (j < s) {
    const float* src = cluster + (size_t)j * PACK16_ROWS;
    cp_async_bytes16(&dst[lane].a, src);
    cp_async_bytes16(&dst[lane].b, src + 4);
    cp_async_bytes8(&dst[lane].c, src + 8);
  } else {
    dst[lane].a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[lane].b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[lane].c = make_float2(0.0f, 0.0f);
  }
}

// The body of a tile: the warp's R slots (ray[r], window [tmin[r],
// tmax[r]], running best (best_t[r], best_tri[r]); `live`: load_slots'
// mask) against the g clusters cids[0..g-1] (ids outside [0, C) skipped),
// each staged into the warp's part of `smem` and swept. MODE 0 is the
// default sweep, MODE_FIRST its first-slot fold, MODE_SUB_SKIP and
// MODE_PACK_T the options (below). tile_sweep's tuned instances and
// slot_sweep's run it.
template <int S, int R, int MODE>
__device__ __forceinline__ void sweep_clusters(
    const float* __restrict__ tri_pack, const int* __restrict__ cids, int g,
    int n_clusters, unsigned live, const Ray* ray, const float* tmin,
    const float* tmax, float* best_t, int* best_tri, unsigned char* smem,
    int warp, int lane) {
  if (live == 0u) return;
  constexpr int ROWS =
      MODE == MODE_SUB_SKIP || MODE == MODE_PACK_T ? PACK16_ROWS : PACK_ROWS;
  for (int i = 0; i < g; ++i) {
    const int cid = cids[i];
    if (cid < 0 || cid >= n_clusters) continue;
    const float* cluster = tri_pack + (size_t)cid * ROWS * S;
    if constexpr (MODE == MODE_SUB_SKIP) {
      static_assert(S % SUB == 0, "whole sub-slabs only");
      constexpr int NS = S / SUB;
      Staged<S>* st = reinterpret_cast<Staged<S>*>(smem) + warp;
      stage_candidate<S>(st, cluster, lane);
      cp_async_wait_all();
      __syncwarp();
#pragma unroll 1
      for (int k = 0; k < NS; ++k) {
        const float4 lo =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS);
        const float4 hi =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS + 4);
        const float box[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
        float cap[R];
        unsigned go = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cap[r] = fminf(tmax[r], best_t[r]);
          if ((live >> r) & 1u) {
            const bool touch = sub_slab_lane(
                box, ray[r], 1.0f / ray[r].dx, 1.0f / ray[r].dy,
                1.0f / ray[r].dz, tmin[r], cap[r]);
            if (__any_sync(FULL_MASK, touch)) go |= 1u << r;
          }
        }
        if (go != 0u) {
          sweep_live<R, SUB>(st->tri + k * SUB, go, ray, tmin, cap, best_t,
                             best_tri);
        }
      }
    } else {
      TriRec* buf = reinterpret_cast<TriRec*>(smem) + (size_t)warp * S;
      if constexpr (MODE == MODE_PACK_T) {
        stage_cluster_rows_warp<S>(buf, cluster, lane);
      } else {
        stage_cluster_warp<S>(buf, cluster, lane);
      }
      cp_async_wait_all();
      __syncwarp();
      sweep_live<R, S, MODE == MODE_FIRST>(buf, live, ray, tmin, tmax, best_t,
                                           best_tri);
    }
    __syncwarp();  // every lane is done with the buffer
  }
}

// The generic instances' body (S at run time, one ray a thread, see
// "the generic instance" below): the lane's ray against the g clusters
// cids[0..g-1], each walked in chunks of 32 staged into the warp's buffer.
template <int MODE>
__device__ __forceinline__ void sweep_clusters_generic(
    const float* __restrict__ tri_pack, const int* __restrict__ cids, int g,
    int n_clusters, int s, const Ray& ray, float tmin, float tmax,
    float* best_t, int* best_tri, TriRec* buf, int lane) {
  if (!__any_sync(FULL_MASK, tmax >= tmin)) return;
  const int rows = MODE == MODE_SUB_SKIP || MODE == MODE_PACK_T ? PACK16_ROWS
                                                                 : PACK_ROWS;
  for (int i = 0; i < g; ++i) {
    const int cid = cids[i];
    if (cid < 0 || cid >= n_clusters) continue;
    const float* cluster = tri_pack + (size_t)cid * rows * s;
#pragma unroll 1
    for (int c0 = 0; c0 < s; c0 += CHUNK) {
      float cap = tmax;
      if constexpr (MODE == MODE_SUB_SKIP) {
        float box[6];
        load_box(cluster, s, c0 / CHUNK, box);
        cap = fminf(tmax, *best_t);
        const bool touch = sub_slab_lane(box, ray, 1.0f / ray.dx,
                                         1.0f / ray.dy, 1.0f / ray.dz,
                                         tmin, cap);
        if (!__any_sync(FULL_MASK, touch)) continue;
      }
      if constexpr (MODE == MODE_PACK_T) {
        stage_chunk_rows16_warp(buf, cluster, s, c0, lane);
      } else {
        stage_chunk_warp<PACK_ROWS>(buf, cluster, s, c0, lane);
      }
      cp_async_wait_all();
      __syncwarp();
      sweep_live<1, CHUNK, MODE == MODE_FIRST>(buf, 1u, &ray, &tmin, &cap,
                                               best_t, best_tri);
      __syncwarp();  // every lane is done with the buffer
    }
  }
}

template <int S, int T, int R, bool FIRST = false>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(R))
    tile_sweep_kernel(const float* __restrict__ tri_pack,
                      const float* __restrict__ rays,
                      const int* __restrict__ tile_cid,
                      float* __restrict__ t_out, int* __restrict__ tri_out,
                      int nt, int g, int n_clusters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WPT = T / (32 * R);  // warps per tile
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= nt * WPT) return;  // whole warps leave; there is no block barrier
  const size_t tile = (size_t)(unit / WPT);
  const int base = (unit % WPT) * 32 * R;

  Ray ray[R];
  float tmin[R], tmax[R], best_t[R];
  int best_tri[R];
  const unsigned live =
      load_slots<T, R>(rays, tile, base, lane, ray, tmin, tmax);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = INFINITY;
    best_tri[r] = I32_MAX;
  }
  sweep_clusters<S, R, FIRST ? MODE_FIRST : 0>(
      tri_pack, tile_cid + tile * g, g, n_clusters, live, ray, tmin, tmax,
      best_t, best_tri, smem, warp, lane);
  store_slots<T, R>(t_out, tri_out, tile, base, lane, best_t, best_tri);
}

// Four warps' buffers: 48 KB at S = 256, the most a launch gets without
// asking for more.
template <int S>
constexpr size_t smem_bytes() {
  static_assert(SWEEP_WARPS * S * sizeof(TriRec) <= 48 * 1024,
                "the staging buffers exceed the default shared memory");
  return SWEEP_WARPS * S * sizeof(TriRec);
}

template <int S, int T, int R, bool FIRST = false>
static int launch(const void* tri_pack, const void* rays, const void* tile_cid,
                  void* t_out, void* tri_out, int nt, int g, int n_clusters,
                  cudaStream_t stream) {
  const int units = nt * (T / (32 * R));
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  tile_sweep_kernel<S, T, R, FIRST>
      <<<blocks, SWEEP_WARPS * 32, smem_bytes<S>(), stream>>>(
          (const float*)tri_pack, (const float*)rays, (const int*)tile_cid,
          (float*)t_out, (int*)tri_out, nt, g, n_clusters);
  return (int)cudaGetLastError();
}

template <int S, int T, int R, bool FIRST = false>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, tile_sweep_kernel<S, T, R, FIRST>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tile_sweep_kernel<S, T, R, FIRST>, SWEEP_WARPS * 32,
      smem_bytes<S>());
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

// Rays a thread: four at T = 128, the closest path's tiles (one warp a tile,
// a quarter of the staging); one at the shadow cascade's T = 64 and 256,
// whose launches are small and need the warps.
constexpr int rays_per_thread(int t_lanes) { return t_lanes == 128 ? 4 : 1; }

#define NO_INSTANCE (-1)  // no cudaError_t is negative
// S = 2: the worklist backend's fallbacks on a scene cut into clusters of
// two triangles (more than 2048 clusters on a small scene, a test shape).
#define FOR_INSTANCES(CALL)                                              \
  CALL(128, 64) CALL(128, 128) CALL(128, 256) CALL(256, 64) CALL(256, 128) \
  CALL(256, 256) CALL(2, 64) CALL(2, 128)

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok), or
// NO_INSTANCE for an (S, T) that is not compiled.
extern "C" int ctiles_sweep(const void* tri_pack, const void* rays,
                            const void* tile_cid, void* t_out, void* tri_out,
                            int nt, int g, int s, int t_lanes, int n_clusters,
                            void* stream) {
  if (nt <= 0) return 0;
  if (g < 1) return (int)cudaErrorInvalidValue;
#define LAUNCH(S_, T_)                                                       \
  if (s == S_ && t_lanes == T_)                                              \
    return launch<S_, T_, rays_per_thread(T_)>(                              \
        tri_pack, rays, tile_cid, t_out, tri_out, nt, g, n_clusters,         \
        (cudaStream_t)stream);
  FOR_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, T) instance and the warps an SM holds of
// it.
extern "C" int ctiles_sweep_occupancy(int s, int t_lanes, int* regs,
                                      int* warps_per_sm) {
#define OCCUPANCY(S_, T_) \
  if (s == S_ && t_lanes == T_) \
    return occupancy<S_, T_, rays_per_thread(T_)>(regs, warps_per_sm);
  FOR_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the first-slot instance (see the header) -------------------------------

// The packet cascade's shapes: blocks of 64 (the overflow fallbacks) and of
// 256 (the "packets" backend), clusters of 128.
#define FOR_FIRST_INSTANCES(CALL) CALL(128, 64) CALL(128, 256)

// As ctiles_sweep, with the first-slot tie rule; NO_INSTANCE for an (S, T)
// that is not compiled.
extern "C" int ctiles_sweep_first(const void* tri_pack, const void* rays,
                                  const void* tile_cid, void* t_out,
                                  void* tri_out, int nt, int g, int s,
                                  int t_lanes, int n_clusters, void* stream) {
  if (nt <= 0) return 0;
  if (g < 1) return (int)cudaErrorInvalidValue;
#define LAUNCH(S_, T_)                                                       \
  if (s == S_ && t_lanes == T_)                                              \
    return launch<S_, T_, rays_per_thread(T_), true>(                        \
        tri_pack, rays, tile_cid, t_out, tri_out, nt, g, n_clusters,         \
        (cudaStream_t)stream);
  FOR_FIRST_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

extern "C" int ctiles_sweep_first_occupancy(int s, int t_lanes, int* regs,
                                            int* warps_per_sm) {
#define OCCUPANCY(S_, T_) \
  if (s == S_ && t_lanes == T_) \
    return occupancy<S_, T_, rays_per_thread(T_), true>(regs, warps_per_sm);
  FOR_FIRST_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the options: sub_skip and pack_t (pallas_ctiles.py:168-231) ---------
//
// Instances of their own, so the default kernel above keeps its code,
// registers and occupancy. Both give the bits of the default sweep.
//
// sub_skip reads the [C, 16, S] pack: the warp stages a cluster with its
// sub-slab boxes (rows 10-15, mt.cuh stage_candidate) and sweeps sub-slab k
// of its slot r only if some lane's segment [t_min, min(t_max, best so far)]
// touches the box: the vote is per slot of 32 lanes (all R slots of a
// thread are voted on separately, each with its running best of that
// moment), so a slot whose lanes already hold nearer hits skips far
// sub-slabs. A lane whose segment misses a box can pass no test in it, so
// no bit changes. The segment's bound is also the test's window inside the
// sub-slab: a test with t above the running best changes nothing.
//
// pack_t reads the [C, S, 16] pack, triangle j's ten words contiguous at
// word 16 j: the warp stages each triangle with three cp.async copies (16,
// 16 and 8 bytes) into the same TriRec layout, in place of ten transposing
// copies of 4 bytes; the inner loop is the default's.

template <int S, int MODE>
constexpr size_t options_smem_bytes() {
  return MODE == MODE_SUB_SKIP ? SWEEP_WARPS * sizeof(Staged<S>)
                               : SWEEP_WARPS * S * sizeof(TriRec);
}

template <int S, int T, int R, int MODE>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(R))
    tile_sweep_options_kernel(const float* __restrict__ tri_pack,
                              const float* __restrict__ rays,
                              const int* __restrict__ tile_cid,
                              float* __restrict__ t_out,
                              int* __restrict__ tri_out, int nt, int g,
                              int n_clusters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WPT = T / (32 * R);  // warps per tile
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= nt * WPT) return;  // whole warps leave; there is no block barrier
  const size_t tile = (size_t)(unit / WPT);
  const int base = (unit % WPT) * 32 * R;

  Ray ray[R];
  float tmin[R], tmax[R], best_t[R];
  int best_tri[R];
  const unsigned live =
      load_slots<T, R>(rays, tile, base, lane, ray, tmin, tmax);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = INFINITY;
    best_tri[r] = I32_MAX;
  }
  sweep_clusters<S, R, MODE>(tri_pack, tile_cid + tile * g, g, n_clusters,
                             live, ray, tmin, tmax, best_t, best_tri, smem,
                             warp, lane);
  store_slots<T, R>(t_out, tri_out, tile, base, lane, best_t, best_tri);
}

// Allows an instance its dynamic shared memory (sub_skip at S = 256 takes
// 49 KB, above the default 48 KB) on the current device.
template <int S, int T, int R, int MODE>
static cudaError_t configure_options() {
  return cudaFuncSetAttribute(tile_sweep_options_kernel<S, T, R, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)options_smem_bytes<S, MODE>());
}

template <int S, int T, int R, int MODE>
static int launch_options(const void* tri_pack, const void* rays,
                          const void* tile_cid, void* t_out, void* tri_out,
                          int nt, int g, int n_clusters, cudaStream_t stream) {
  const cudaError_t err = configure_options<S, T, R, MODE>();
  if (err != cudaSuccess) return (int)err;
  const int units = nt * (T / (32 * R));
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  tile_sweep_options_kernel<S, T, R, MODE>
      <<<blocks, SWEEP_WARPS * 32, options_smem_bytes<S, MODE>(), stream>>>(
          (const float*)tri_pack, (const float*)rays, (const int*)tile_cid,
          (float*)t_out, (int*)tri_out, nt, g, n_clusters);
  return (int)cudaGetLastError();
}

template <int S, int T, int R, int MODE>
static int occupancy_options(int* regs, int* warps_per_sm) {
  cudaError_t err = configure_options<S, T, R, MODE>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, tile_sweep_options_kernel<S, T, R, MODE>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tile_sweep_options_kernel<S, T, R, MODE>, SWEEP_WARPS * 32,
      options_smem_bytes<S, MODE>());
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

// The ctiles paths' shapes: closest waves (T 128, S 128 and 256) and the
// lane-major shadow waves (T 64, S 128).
#define FOR_OPTION_INSTANCES(CALL)                                      \
  CALL(128, 128, MODE_SUB_SKIP) CALL(256, 128, MODE_SUB_SKIP)           \
  CALL(128, 64, MODE_SUB_SKIP) CALL(128, 128, MODE_PACK_T)              \
  CALL(256, 128, MODE_PACK_T) CALL(128, 64, MODE_PACK_T)

// As ctiles_sweep, with `mode` MODE_SUB_SKIP (tri_pack [C, 16, S]) or
// MODE_PACK_T (tri_pack [C, S, 16]); NO_INSTANCE for another (S, T, mode).
extern "C" int ctiles_sweep_options(const void* tri_pack, const void* rays,
                                    const void* tile_cid, void* t_out,
                                    void* tri_out, int nt, int g, int s,
                                    int t_lanes, int n_clusters, int mode,
                                    void* stream) {
  if (nt <= 0) return 0;
  if (g < 1) return (int)cudaErrorInvalidValue;
#define LAUNCH(S_, T_, M_)                                                 \
  if (s == S_ && t_lanes == T_ && mode == M_)                              \
    return launch_options<S_, T_, rays_per_thread(T_), M_>(                \
        tri_pack, rays, tile_cid, t_out, tri_out, nt, g, n_clusters,       \
        (cudaStream_t)stream);
  FOR_OPTION_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

extern "C" int ctiles_sweep_options_occupancy(int s, int t_lanes, int mode,
                                              int* regs, int* warps_per_sm) {
#define OCCUPANCY(S_, T_, M_)                        \
  if (s == S_ && t_lanes == T_ && mode == M_)        \
    return occupancy_options<S_, T_, rays_per_thread(T_), M_>(regs, \
                                                              warps_per_sm);
  FOR_OPTION_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the generic instance: any S, any T (mt.cuh CHUNK) ---------------------
//
// For the (S, T) that no instance above is compiled for: S >= 1 and T >= 1
// at run time. One ray a thread (R = 1), ceil(T / 32) warps a tile (lanes
// past T are dead), four warps a thread block that share nothing. Each
// cluster is walked in chunks of 32 triangles staged into the warp's buffer
// (mt.cuh stage_chunk_warp; zeros past S) and tested by sweep_live<1, 32>,
// the default instance's loop. MODE as ctiles_sweep_options' (0: the
// default [C, 10, S] pack): under sub_skip a chunk is a sub-slab and is
// staged and swept only if some lane's [t_min, min(t_max, best so far)]
// touches its box (read from the pack's rows 10-15); under pack_t a chunk
// is staged from the [C, S, 16] pack, three copies a triangle; under
// MODE_FIRST a chunk is staged as under 0 and folded by the first-slot rule
// (the chunks in order, so slots in order).

template <int MODE>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    tile_sweep_generic_kernel(const float* __restrict__ tri_pack,
                              const float* __restrict__ rays,
                              const int* __restrict__ tile_cid,
                              float* __restrict__ t_out,
                              int* __restrict__ tri_out, int nt, int g,
                              int n_clusters, int s, int t_lanes) {
  __shared__ TriRec bufs[SWEEP_WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpt = (t_lanes + 31) >> 5;  // warps per tile
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= nt * wpt) return;  // whole warps leave; there is no block barrier
  const size_t tile = (size_t)(unit / wpt);
  const int off = (unit % wpt) * 32 + lane;
  float tmin, tmax;
  const Ray ray =
      load_lane(rays + tile * RAY_ROWS * t_lanes, t_lanes, off, &tmin, &tmax);
  float best_t = INFINITY;
  int best_tri = I32_MAX;
  sweep_clusters_generic<MODE>(tri_pack, tile_cid + tile * g, g, n_clusters,
                               s, ray, tmin, tmax, &best_t, &best_tri,
                               bufs[warp], lane);
  if (off < t_lanes) {
    t_out[tile * t_lanes + off] = best_t;
    tri_out[tile * t_lanes + off] = best_tri;
  }
}

// The generic instance of ctiles_sweep (mode 0), ctiles_sweep_options
// (MODE_SUB_SKIP, MODE_PACK_T) and ctiles_sweep_first (MODE_FIRST), with
// their arguments, for any S, T >= 1.
extern "C" int ctiles_sweep_generic(const void* tri_pack, const void* rays,
                                    const void* tile_cid, void* t_out,
                                    void* tri_out, int nt, int g, int s,
                                    int t_lanes, int n_clusters, int mode,
                                    void* stream) {
  if (nt <= 0) return 0;
  if (g < 1 || s < 1 || t_lanes < 1) return (int)cudaErrorInvalidValue;
  const int units = nt * ((t_lanes + 31) / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
#define LAUNCH(M_)                                                        \
  tile_sweep_generic_kernel<M_><<<blocks, SWEEP_WARPS * 32, 0,            \
                                  (cudaStream_t)stream>>>(                \
      (const float*)tri_pack, (const float*)rays, (const int*)tile_cid,   \
      (float*)t_out, (int*)tri_out, nt, g, n_clusters, s, t_lanes);
  if (mode == MODE_SUB_SKIP) {
    LAUNCH(MODE_SUB_SKIP)
  } else if (mode == MODE_PACK_T) {
    LAUNCH(MODE_PACK_T)
  } else if (mode == MODE_FIRST) {
    LAUNCH(MODE_FIRST)
  } else if (mode == 0) {
    LAUNCH(0)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// ---- slot_sweep: the ctiles / pairs sweep over static slot tables --------
//
// The sweep of path_tracer_ai_tpu/accel/ctiles.py `_sweep_resolve` (the
// `fori_loop`s at :629, :646 and :666 over a dynamic chunk count, each chunk
// a `tile_sweep`, then the row scatter-min / scatter-max resolve) and of
// path_tracer_ai_tpu/accel/pairs.py `_sweep_tiles` (the `fori_loop` at :259),
// in one launch that reads its tile count from device memory: the host
// reads nothing. Its body is tile_sweep's (sweep_clusters, or
// sweep_clusters_generic for the generic instance: the same arithmetic, the
// same options).
//
// Inputs: a ray table [rows + 1, 8, b] (row `rows` is the dead row: o 0,
// d 1, t_max -1), static slot tables of nt_cap * tb slots (slot_ref: a
// flat pair id, -1 = padding; its ray row is ref / cap, the dead row for
// -1), tile i's cluster id at tile_cid[i * cid_stride], and n_tiles, the
// live tile count, in device memory. Lane l of tile i is lane l % b of the
// row of slot i * tb + l / b (T = tb * b lanes a tile), as ctiles' chunked
// gather `ray_blocks[blk]` lays it out.
//
// Outputs, by out_mode:
//   SLOT_OUT_CLOSEST  per row lane, the lexicographic (t, tri) minimum over
//                     every slot of the row, through one 64-bit atomicMin of
//                     (order_key(t) << 32 | tri ^ 2^31) a lane that passed
//                     some test; t is the f32 of its key, -0.0 taken as
//                     +0.0 (the two compare equal, and the two-pass resolve
//                     keeps the minimum id among them), then decoded by
//                     slot_fold_decode in the same call. A row no slot
//                     reaches stays (inf, INT32_MAX).
//   SLOT_OUT_ANY      per row lane, 1 where some slot lane has tri !=
//                     INT32_MAX (a test passed), else the zeros it got.
//   SLOT_OUT_SLOT     per slot lane (tile i * T + l), tile_sweep's (t, tri);
//                     tiles past n_tiles get (inf, INT32_MAX).
//
// Design: a persistent grid (the card's resident thread blocks, at most
// what nt_cap needs) whose warps stride the units (tile, warp part) up to
// n_tiles * warps a tile: a render's static cap is ~393 k tiles of which a
// fraction are live, and CTAs that exit at once would cost more than the
// stride. What bounds it: the sweep's (instruction throughput, as tile_sweep);
// the gather of a lane's ray (8 words from the row its slot names) and the
// fold's one atomic per hit lane add little.

#define SLOT_OUT_CLOSEST 0
#define SLOT_OUT_ANY 1
#define SLOT_OUT_SLOT 2

struct SlotArgs {
  const float* tri_pack;
  const float* rays;
  const int* slot_ref;
  const int* tile_cid;
  const int* n_tiles;
  unsigned long long* key;
  unsigned char* occ;
  float* t_out;
  int* tri_out;
  int nt_cap, tb, b, rows, cap, cid_stride, n_clusters, s, t_lanes, out_mode;
};

// Lane l of tile `tile`: its ray, window and the fold's destination (row *
// b + lane in row; -1 for a padding slot or a lane past T).
__device__ __forceinline__ Ray load_slot_lane(const SlotArgs& a, size_t tile,
                                              int l, float* tmin, float* tmax,
                                              int* dst) {
  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  *tmin = 0.0f;
  *tmax = -1.0f;
  *dst = -1;
  if (l >= a.t_lanes) return ray;
  const int k = l / a.b, w = l - k * a.b;
  const int ref = __ldg(a.slot_ref + tile * a.tb + k);
  const int row = ref >= 0 ? ref / a.cap : a.rows;
  if (ref >= 0) *dst = row * a.b + w;
  const float* rp = a.rays + (size_t)row * RAY_ROWS * a.b + w;
  ray = load_ray(rp, a.b);
  *tmax = rp[6 * a.b];
  *tmin = rp[7 * a.b];
  return ray;
}

__device__ __forceinline__ unsigned long long fold_key(float t, int tri) {
  const float tz = t == 0.0f ? 0.0f : t;  // -0.0 and +0.0: one t
  return ((unsigned long long)order_key(tz) << 32) |
         ((unsigned)tri ^ 0x80000000u);
}

__device__ __forceinline__ void slot_emit(const SlotArgs& a, size_t tile,
                                          int l, int dst, float t, int tri) {
  if (a.out_mode == SLOT_OUT_SLOT) {
    if (l < a.t_lanes) {
      a.t_out[tile * a.t_lanes + l] = t;
      a.tri_out[tile * a.t_lanes + l] = tri;
    }
  } else if (dst >= 0 && tri != I32_MAX) {  // tri == INT32_MAX: no test passed
    if (a.out_mode == SLOT_OUT_ANY) {
      a.occ[dst] = 1;
    } else {
      atomicMin(a.key + dst, fold_key(t, tri));
    }
  }
}

// Per-slot output: the lanes of the tiles past the live count.
__device__ __forceinline__ void slot_fill(const SlotArgs& a, long long live) {
  if (a.out_mode != SLOT_OUT_SLOT) return;
  const size_t total = (size_t)a.nt_cap * a.t_lanes;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)live * a.t_lanes + (size_t)blockIdx.x * blockDim.x +
                  threadIdx.x;
       i < total; i += step) {
    a.t_out[i] = INFINITY;
    a.tri_out[i] = I32_MAX;
  }
}

__device__ __forceinline__ long long live_tiles(const SlotArgs& a) {
  const int n = *a.n_tiles;
  return n < 0 ? 0 : (n < a.nt_cap ? n : a.nt_cap);
}

template <int S, int T, int R, int MODE>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(R))
    slot_sweep_kernel(const SlotArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WPT = T / (32 * R);  // warps per tile
  const long long tiles = live_tiles(a);
  const long long stride = (long long)gridDim.x * SWEEP_WARPS;
  for (long long unit = (long long)blockIdx.x * SWEEP_WARPS + warp;
       unit < tiles * WPT; unit += stride) {  // warp-uniform
    const size_t tile = (size_t)(unit / WPT);
    const int base = (int)(unit % WPT) * 32 * R;
    Ray ray[R];
    float tmin[R], tmax[R], best_t[R];
    int best_tri[R], dst[R];
    unsigned live = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ray[r] = load_slot_lane(a, tile, base + lane + 32 * r, &tmin[r],
                              &tmax[r], &dst[r]);
      if (__any_sync(FULL_MASK, tmax[r] >= tmin[r])) live |= 1u << r;
      best_t[r] = INFINITY;
      best_tri[r] = I32_MAX;
    }
    sweep_clusters<S, R, MODE>(a.tri_pack, a.tile_cid + tile * a.cid_stride,
                               1, a.n_clusters, live, ray, tmin, tmax, best_t,
                               best_tri, smem, warp, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      slot_emit(a, tile, base + lane + 32 * r, dst[r], best_t[r],
                best_tri[r]);
    }
  }
  slot_fill(a, tiles);
}

template <int MODE>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    slot_sweep_generic_kernel(const SlotArgs a) {
  __shared__ TriRec bufs[SWEEP_WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpt = (a.t_lanes + 31) >> 5;  // warps per tile
  const long long tiles = live_tiles(a);
  const long long stride = (long long)gridDim.x * SWEEP_WARPS;
  for (long long unit = (long long)blockIdx.x * SWEEP_WARPS + warp;
       unit < tiles * wpt; unit += stride) {  // warp-uniform
    const size_t tile = (size_t)(unit / wpt);
    const int l = (int)(unit % wpt) * 32 + lane;
    float tmin, tmax;
    int dst;
    const Ray ray = load_slot_lane(a, tile, l, &tmin, &tmax, &dst);
    float best_t = INFINITY;
    int best_tri = I32_MAX;
    sweep_clusters_generic<MODE>(a.tri_pack, a.tile_cid + tile * a.cid_stride,
                                 1, a.n_clusters, a.s, ray, tmin, tmax,
                                 &best_t, &best_tri, bufs[warp], lane);
    slot_emit(a, tile, l, dst, best_t, best_tri);
  }
  slot_fill(a, tiles);
}

// The closest fold's keys -> (t, tri) per row lane.
__global__ void slot_fold_decode(const unsigned long long* __restrict__ key,
                                 float* __restrict__ t_out,
                                 int* __restrict__ tri_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = key[i];
  t_out[i] = key_float((unsigned)(k >> 32));
  tri_out[i] = (int)((unsigned)k ^ 0x80000000u);
}

template <int S, int MODE>
constexpr size_t slot_smem_bytes() {
  return MODE == MODE_SUB_SKIP ? SWEEP_WARPS * sizeof(Staged<S>)
                               : SWEEP_WARPS * S * sizeof(TriRec);
}

// The card's resident thread blocks of `kernel` (at least one), capped at
// what `want` blocks need.
template <typename K>
static int persistent_blocks(K kernel, size_t smem, long long want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                SWEEP_WARPS * 32, smem);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long n = want < resident ? want : resident;
  return (int)(n > 0 ? n : 1);
}

static int slot_decode(const SlotArgs& a, cudaStream_t stream) {
  const int n = a.rows * a.b;
  if (a.out_mode != SLOT_OUT_CLOSEST || n <= 0) return 0;
  slot_fold_decode<<<(n + 255) / 256, 256, 0, stream>>>(a.key, a.t_out,
                                                        a.tri_out, n);
  return (int)cudaGetLastError();
}

template <int S, int T, int R, int MODE>
static int launch_slot(const SlotArgs& a, cudaStream_t stream) {
  constexpr size_t smem = slot_smem_bytes<S, MODE>();
  if (a.nt_cap > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        slot_sweep_kernel<S, T, R, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long units = (long long)a.nt_cap * (T / (32 * R));
    const int blocks = persistent_blocks(
        slot_sweep_kernel<S, T, R, MODE>, smem,
        (units + SWEEP_WARPS - 1) / SWEEP_WARPS);
    slot_sweep_kernel<S, T, R, MODE>
        <<<blocks, SWEEP_WARPS * 32, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return slot_decode(a, stream);
}

template <int MODE>
static int launch_slot_generic(const SlotArgs& a, cudaStream_t stream) {
  if (a.nt_cap > 0) {
    const long long units = (long long)a.nt_cap * ((a.t_lanes + 31) / 32);
    const int blocks =
        persistent_blocks(slot_sweep_generic_kernel<MODE>, 0,
                          (units + SWEEP_WARPS - 1) / SWEEP_WARPS);
    slot_sweep_generic_kernel<MODE>
        <<<blocks, SWEEP_WARPS * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return slot_decode(a, stream);
}

// The routes' shapes: the main path's closest waves (T 128, S 256), the
// pair tiles and the ctiles backend's closest waves (T 128, S 128). Every
// other shape and both options go to slot_sweep_generic: its tuned option
// instances were slower than the generic ones on the main path's waves.
#define FOR_SLOT_INSTANCES(CALL) CALL(256, 128, 0) CALL(128, 128, 0)

#define SLOT_PARAMS                                                         \
  const void *tri_pack, const void *rays, const void *slot_ref,            \
      const void *tile_cid, const void *n_tiles, void *key, void *occ,     \
      void *t_out, void *tri_out, int nt_cap, int tb, int b, int rows,     \
      int cap, int cid_stride, int n_clusters, int s, int t_lanes,         \
      int out_mode, int mode, void *stream

static SlotArgs slot_args(const void* tri_pack, const void* rays,
                          const void* slot_ref, const void* tile_cid,
                          const void* n_tiles, void* key, void* occ,
                          void* t_out, void* tri_out, int nt_cap, int tb,
                          int b, int rows, int cap, int cid_stride,
                          int n_clusters, int s, int t_lanes, int out_mode) {
  return SlotArgs{(const float*)tri_pack, (const float*)rays,
                  (const int*)slot_ref,   (const int*)tile_cid,
                  (const int*)n_tiles,    (unsigned long long*)key,
                  (unsigned char*)occ,    (float*)t_out,
                  (int*)tri_out,          nt_cap,
                  tb,                     b,
                  rows,                   cap,
                  cid_stride,             n_clusters,
                  s,                      t_lanes,
                  out_mode};
}

static bool slot_args_ok(int nt_cap, int tb, int b, int rows, int cap,
                         int s, int t_lanes, int out_mode, int mode) {
  return nt_cap >= 0 && tb >= 1 && b >= 1 && rows >= 0 && cap >= 1 &&
         s >= 1 && t_lanes == tb * b && out_mode >= SLOT_OUT_CLOSEST &&
         out_mode <= SLOT_OUT_SLOT &&
         (mode == 0 || mode == MODE_SUB_SKIP || mode == MODE_PACK_T);
}

#define SLOT_ARGS                                                          \
  slot_args(tri_pack, rays, slot_ref, tile_cid, n_tiles, key, occ, t_out, \
            tri_out, nt_cap, tb, b, rows, cap, cid_stride, n_clusters, s, \
            t_lanes, out_mode)

// One slot sweep (see above) on `stream`, and for SLOT_OUT_CLOSEST the
// decode of its keys (key: rows * b words of the miss key (inf, INT32_MAX));
// mode 0, MODE_SUB_SKIP ([C, 16, S] pack) or MODE_PACK_T ([C, S, 16]).
// Returns the cudaError_t (0 = ok), or NO_INSTANCE for an (S, T, mode) that
// is not compiled.
extern "C" int slot_sweep(SLOT_PARAMS) {
  if (!slot_args_ok(nt_cap, tb, b, rows, cap, s, t_lanes, out_mode, mode)) {
    return (int)cudaErrorInvalidValue;
  }
#define LAUNCH(S_, T_, M_)                                                 \
  if (s == S_ && t_lanes == T_ && mode == M_)                              \
    return launch_slot<S_, T_, rays_per_thread(T_), M_>(                   \
        SLOT_ARGS, (cudaStream_t)stream);
  FOR_SLOT_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// The generic instance of slot_sweep, with its arguments, for any S, T.
extern "C" int slot_sweep_generic(SLOT_PARAMS) {
  if (!slot_args_ok(nt_cap, tb, b, rows, cap, s, t_lanes, out_mode, mode)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == MODE_SUB_SKIP) {
    return launch_slot_generic<MODE_SUB_SKIP>(SLOT_ARGS,
                                              (cudaStream_t)stream);
  }
  if (mode == MODE_PACK_T) {
    return launch_slot_generic<MODE_PACK_T>(SLOT_ARGS, (cudaStream_t)stream);
  }
  return launch_slot_generic<0>(SLOT_ARGS, (cudaStream_t)stream);
}

template <typename K>
static int slot_occupancy_of(K kernel, size_t smem, int* regs,
                             int* warps_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      SWEEP_WARPS * 32, smem);
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

// Registers per thread and resident warps per SM of the (S, T, mode)
// instance (S = 0: the generic one of that mode).
extern "C" int slot_sweep_occupancy(int s, int t_lanes, int mode, int* regs,
                                    int* warps_per_sm) {
  if (s == 0) {
    if (mode == MODE_SUB_SKIP) {
      return slot_occupancy_of(slot_sweep_generic_kernel<MODE_SUB_SKIP>, 0,
                               regs, warps_per_sm);
    }
    if (mode == MODE_PACK_T) {
      return slot_occupancy_of(slot_sweep_generic_kernel<MODE_PACK_T>, 0,
                               regs, warps_per_sm);
    }
    return slot_occupancy_of(slot_sweep_generic_kernel<0>, 0, regs,
                             warps_per_sm);
  }
#define OCCUPANCY(S_, T_, M_)                                              \
  if (s == S_ && t_lanes == T_ && mode == M_)                              \
    return slot_occupancy_of(                                              \
        slot_sweep_kernel<S_, T_, rays_per_thread(T_), M_>,                \
        slot_smem_bytes<S_, M_>(), regs, warps_per_sm);
  FOR_SLOT_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the cascade stage: one stage of the packet cascade's loop -------------
//
// The packet cascades' folds of the cascade stage (stage.cuh: the loop, its
// count, k and the lists of the blocks that can still change, shared with
// the fused cascades' folds in fused_anyhit.cu and fused_closest.cu), for
// `any_hit_packets` and `closest_hit_packets`. Any hit (TileFold<true>):
// occ |= some test passes. Lanes occluded earlier or dead are not tested
// (anyhit_run's early exit), which changes no bit: occlusion is an OR.
// First-slot closest (TileFold<false>): a lane is tested with t_max =
// min(t_max, best t) and folded by sweep_run's first-slot rule from its
// running best (a pass replaces it only with t < best), which is the
// reference's (min t, first slot at it) followed by `ct < best_t`.
//
// The stage's small tail stages leave most of the card idle when a slot is
// one warp's serial work (G clusters x S triangles a lane), so W warps take
// a slot (W in 1, 2, 4, 8 at run time: the wrapper's split_warps, from the
// stage's size and the resident warps). A team of W warps of one thread
// block takes a slot; its g x S triangles, in chunks of 32 (g clusters of
// S / 32), are cut into W contiguous ranges in slot order, one a warp, each
// folded from the slot's carry as the W = 1 sweep folds. The team combines
// them in shared memory: any hit by OR (each warp also ORs its lanes'
// occlusion into the team's word after each chunk, and leaves once every
// lane is occluded or dead); first slot by taking range p's (t, id) only
// where t < the best of ranges 0 .. p - 1, which keeps the first slot at
// the minimum (argmin's bits, -0.0 against +0.0 too), and only then writing
// where that t < the running best. Within a pass each slot is written by
// one team: the carry needs no atomics. A range that holds a whole cluster
// is staged and swept at once, as tile_sweep does (all of them at W = 1);
// the generic instance (S and T at run time) stages chunk by chunk (mt.cuh
// CHUNK, zeros past S). A warp starts the copy of its range's first piece
// before it reads the slot's rays and carry, so the two latencies overlap:
// at W = 8 a warp's whole range may be one chunk.
//
// What bounds it: the sweeps', as tile_sweep's (instruction issue), where a
// stage fills the card; a tail stage's pass is bound by one slot's sweep
// latency, which W divides. A pass adds one barrier and a read of every
// listed block's rays, n_cand and carry.

#include "stage.cuh"

// One warp starts the copy of triangles j0 .. j0 + n - 1 (rows 0-9; n a
// multiple of 32, j0 + n <= S) of a [10, S] cluster into n TriRecs. The
// caller waits and __syncwarp()s.
template <int S>
__device__ __forceinline__ void stage_range_warp(TriRec* dst,
                                                 const float* cluster,
                                                 int j0, int n, int lane) {
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll 1
  for (int k = 0; k < PACK_ROWS; ++k) {
#pragma unroll
    for (int j = lane; j < S; j += 32) {
      if (j < n) cp_async_f32(d + j * TRI_WORDS + k, cluster + k * S + j0 + j);
    }
  }
}

// The lane's occlusion ORed with what the team's other warps have found
// (team: the team's word, null at W = 1); adds the warp's own.
__device__ __forceinline__ bool team_or(unsigned* team, bool occ, int lane) {
  if (team == nullptr) return occ;
  const unsigned mine = __ballot_sync(FULL_MASK, occ);
  if (lane == 0 && mine) atomicOr(team, mine);
  __syncwarp();
  return occ || ((*(volatile unsigned*)team >> lane) & 1u);
}

// Chunk c of a slot's group lies in cluster c / cpc, triangles 32 (c % cpc)
// on. A warp's range [lo, hi) of chunks, cluster by cluster: fn(cid's
// cluster pack, first chunk, end chunk, whether it is the range's first
// piece) for each valid cluster id, until it returns false.
template <typename Fn>
__device__ __forceinline__ void for_range(const StageArgs& a, const int* cids,
                                          int lo, int hi, int cpc, int s,
                                          Fn fn) {
  if (lo >= hi) return;
#pragma unroll 1
  for (int i = lo / cpc; i * cpc < hi; ++i) {
    const int cid = cids[i];
    if (cid < 0 || cid >= a.n_clusters) continue;
    const int c_a = max(lo, i * cpc) - i * cpc;
    const int c_b = min(hi, (i + 1) * cpc) - i * cpc;
    if (!fn(a.tri_pack + (size_t)cid * PACK_ROWS * s, c_a, c_b,
            i == lo / cpc)) {
      return;
    }
  }
}

// Starts the copy of the first piece of a warp's range (its first chunk,
// for the generic instance) into buf, before the unit reads its rays and
// carry, so that the two reads' latencies overlap; false where there is no
// piece to copy. The caller waits (cp_async_wait_all) before the buffer's
// next use, also where it sweeps nothing.
template <int S>
__device__ __forceinline__ bool stage_first(const StageArgs& a,
                                            const int* cids, int lo, int hi,
                                            int cpc, TriRec* buf, int lane) {
  if (lo >= hi) return false;
  const int s = S ? S : a.s;
  const int i = lo / cpc;
  const int cid = cids[i];
  if (cid < 0 || cid >= a.n_clusters) return false;
  const float* cl = a.tri_pack + (size_t)cid * PACK_ROWS * s;
  const int c_a = lo - i * cpc, c_b = min(hi, (i + 1) * cpc) - i * cpc;
  if constexpr (S == 0) {
    stage_chunk_warp<PACK_ROWS>(buf, cl, s, c_a * CHUNK, lane);
  } else if (c_a == 0 && c_b == cpc) {
    stage_cluster_warp<S>(buf, cl, lane);
  } else {
    stage_range_warp<S>(buf, cl, c_a * CHUNK, (c_b - c_a) * CHUNK, lane);
  }
  return true;
}

// Any hit: the warp's range of a slot's group (S = 0: the generic
// instance, chunk by chunk); returns the lane's occlusion. pre: the
// range's first piece is staged (stage_first).
template <int S>
__device__ __forceinline__ bool any_range(const StageArgs& a, const int* cids,
                                          int lo, int hi, int cpc,
                                          const Ray& ray, float tmin,
                                          float tmax, bool dead, bool occ,
                                          TriRec* buf, int lane,
                                          unsigned* team, bool pre) {
  const int s = S ? S : a.s;
  for_range(a, cids, lo, hi, cpc, s, [&](const float* cl, int c_a, int c_b,
                                         bool first) {
    const bool staged = pre && first;
    if constexpr (S == 0) {
#pragma unroll 1
      for (int c = c_a; c < c_b; ++c) {
        if (!(staged && c == c_a)) {
          stage_chunk_warp<PACK_ROWS>(buf, cl, s, c * CHUNK, lane);
        }
        cp_async_wait_all();
        __syncwarp();
        occ = anyhit_run<CHUNK>(buf, ray, tmin, tmax, dead, occ);
        __syncwarp();  // every lane is done with the buffer
        occ = team_or(team, occ, lane);
        if (__all_sync(FULL_MASK, occ || dead)) break;
      }
    } else if (c_a == 0 && c_b == cpc) {  // a whole cluster
      if (!staged) stage_cluster_warp<S>(buf, cl, lane);
      cp_async_wait_all();
      __syncwarp();
      occ = anyhit_run<S>(buf, ray, tmin, tmax, dead, occ);
      __syncwarp();
      occ = team_or(team, occ, lane);
    } else {
      if (!staged) {
        stage_range_warp<S>(buf, cl, c_a * CHUNK, (c_b - c_a) * CHUNK, lane);
      }
      cp_async_wait_all();
      __syncwarp();
#pragma unroll 1
      for (int c = 0; c < c_b - c_a; ++c) {
        occ = anyhit_run<CHUNK>(buf + c * CHUNK, ray, tmin, tmax, dead, occ);
        occ = team_or(team, occ, lane);
        if (__all_sync(FULL_MASK, occ || dead)) break;
      }
      __syncwarp();
    }
    return !__all_sync(FULL_MASK, occ || dead);
  });
  return occ;
}

// First slot: the warp's range of a slot's group folded into (best, id)
// from the running best (a pass replaces it only with t < best). pre: as
// any_range's.
template <int S>
__device__ __forceinline__ void first_range(const StageArgs& a,
                                            const int* cids, int lo, int hi,
                                            int cpc, const Ray& ray,
                                            float tmin, float cap,
                                            float* best, int* id,
                                            TriRec* buf, int lane, bool pre) {
  const int s = S ? S : a.s;
  for_range(a, cids, lo, hi, cpc, s, [&](const float* cl, int c_a, int c_b,
                                         bool first) {
    const bool staged = pre && first;
    if constexpr (S == 0) {
#pragma unroll 1
      for (int c = c_a; c < c_b; ++c) {
        if (!(staged && c == c_a)) {
          stage_chunk_warp<PACK_ROWS>(buf, cl, s, c * CHUNK, lane);
        }
        cp_async_wait_all();
        __syncwarp();
        sweep_run<1, CHUNK, true>(buf, &ray, &tmin, &cap, best, id);
        __syncwarp();  // every lane is done with the buffer
      }
    } else if (c_a == 0 && c_b == cpc) {  // a whole cluster
      if (!staged) stage_cluster_warp<S>(buf, cl, lane);
      cp_async_wait_all();
      __syncwarp();
      sweep_run<1, S, true>(buf, &ray, &tmin, &cap, best, id);
      __syncwarp();
    } else {
      if (!staged) {
        stage_range_warp<S>(buf, cl, c_a * CHUNK, (c_b - c_a) * CHUNK, lane);
      }
      cp_async_wait_all();
      __syncwarp();
#pragma unroll 1
      for (int c = 0; c < c_b - c_a; ++c) {
        sweep_run<1, CHUNK, true>(buf + c * CHUNK, &ray, &tmin, &cap, best,
                                  id);
      }
      __syncwarp();
    }
    return true;
  });
}

// A sweep pass's unit: slot `slot` of listed block b, group k, this warp's
// range (part of w); the team combines; returns the slot's vote on k + 1
// (meaningful in part 0). S = T = 0: the generic instance.
template <bool ANY, int S, int T>
__device__ __forceinline__ unsigned sweep_slot(const StageArgs& a,
                                               StageShared& sh, int b,
                                               int slot, int k, int team,
                                               int part, int w, int round,
                                               int lane, TriRec* buf) {
  const int t_lanes = T ? T : a.t_lanes;
  const int off = slot * 32 + lane;
  const int kk = k < a.kgroups - 1 ? k : a.kgroups - 1;
  const int* cids = a.order_g + ((size_t)b * a.kgroups + kk) * a.g;
  const int cpc = S ? S / CHUNK : (a.s + CHUNK - 1) / CHUNK;
  const int n_ch = a.g * cpc;
  const int lo = part * n_ch / w, hi = (part + 1) * n_ch / w;
  const bool pre = stage_first<S>(a, cids, lo, hi, cpc, buf, lane);
  float tmin, tmax;
  const Ray ray = load_lane(a.rays + (size_t)b * RAY_ROWS * t_lanes, t_lanes,
                            off, &tmin, &tmax);
  const bool in = off < t_lanes;
  const size_t ci = (size_t)b * t_lanes + off;
  const int rb = round & 1;
  const int warp = team * w + part;
  if constexpr (ANY) {
    bool occ = in && __ldcg(a.occ + ci) != 0;
    const bool dead = !(tmax >= tmin);  // can pass no test
    unsigned* tw = w > 1 ? &sh.team_occ[rb][team] : nullptr;
    if (!__all_sync(FULL_MASK, occ || dead)) {
      occ = any_range<S>(a, cids, lo, hi, cpc, ray, tmin, tmax, dead, occ,
                         buf, lane, tw, pre);
    }
    cp_async_wait_all();  // a piece staged and not swept
    __syncwarp();
    if (w > 1) {
      occ = team_or(tw, occ, lane);
      team_sync(team, w);
      if (part != 0) return 0u;
      occ = occ || ((*tw >> lane) & 1u);
      __syncwarp();
      if (lane == 0) *tw = 0u;  // next written two rounds on
    }
    if (in) a.occ[ci] = occ ? 1 : 0;
    return __any_sync(FULL_MASK, !occ && !(tmax < 0.0f)) ? 1u : 0u;
  } else {
    const float bt = in ? __ldcg(a.best_t + ci) : INFINITY;
    // torch.minimum's NaN: a NaN t_max passes no test
    const float cap = tmax != tmax ? tmax : fminf(tmax, bt);
    float best = bt;
    int id = in ? __ldcg(a.best_id + ci) : -1;
    if (__any_sync(FULL_MASK, cap >= tmin)) {
      first_range<S>(a, cids, lo, hi, cpc, ray, tmin, cap, &best, &id, buf,
                     lane, pre);
    }
    cp_async_wait_all();  // a piece staged and not swept
    __syncwarp();
    if (w > 1) {
      if (part != 0) {
        sh.part_t[rb][warp][lane] = best;
        sh.part_id[rb][warp][lane] = id;
      }
      team_sync(team, w);
      if (part != 0) return 0u;
#pragma unroll 1
      for (int p = 1; p < w; ++p) {  // ranges in slot order: the first wins
        const float t = sh.part_t[rb][warp + p][lane];
        if (t < best) {
          best = t;
          id = sh.part_id[rb][warp + p][lane];
        }
      }
    }
    if (in && best < bt) {
      a.best_t[ci] = best;
      a.best_id[ci] = id;
    }
    return __reduce_max_sync(FULL_MASK,
                             order_key(tmax < 0.0f ? -INFINITY : best));
  }
}

template <bool ANY_>
struct TileFold : PacketRule<ANY_> {
  template <int S>
  __host__ __device__ static constexpr size_t warp_bytes() {
    return (size_t)(S ? S : CHUNK) * sizeof(TriRec);
  }
  template <int S, int T>
  static __device__ __forceinline__ unsigned sweep(
      const StageArgs& a, StageShared& sh, int b, int slot, int k, int team,
      int part, int w, int round, int lane, unsigned char* buf) {
    return sweep_slot<ANY_, S, T>(a, sh, b, slot, k, team, part, w, round,
                                  lane, reinterpret_cast<TriRec*>(buf));
  }
};
using TileAny = TileFold<true>;
using TileFirst = TileFold<false>;

// The cascades' shapes: blocks of 64 (the main path's shadows at G 2, the
// overflow fallbacks at G 8) and of 256 (render_sharded, "packets"),
// clusters of 128; G and W at run time.
#define FOR_STAGE_INSTANCES(CALL) CALL(128, 64) CALL(128, 256)

static StageArgs stage_args(const void* tri_pack, const void* rays,
                            const void* order_g, const void* n_cand,
                            const void* entry, void* occ, void* best_t,
                            void* best_id, void* k_io, void* act, void* work,
                            int size, int kgroups, int g, int s, int t_lanes,
                            int n_clusters, int entry_stride, int threshold,
                            int w) {
  unsigned* words = (unsigned*)work;
  return StageArgs{(const float*)tri_pack, (const float*)rays,
                   (const int*)order_g, (const int*)n_cand,
                   (const float*)entry, (unsigned char*)occ, (float*)best_t,
                   (int*)best_id, (int*)k_io, (unsigned char*)act,
                   (unsigned long long*)words,
                   words + STAGE_SYNC_WORDS,
                   words + STAGE_SYNC_WORDS + size,
                   (int*)(words + STAGE_SYNC_WORDS + 2 * (size_t)size),
                   size, kgroups, g, s, t_lanes, n_clusters, entry_stride,
                   threshold, w, 0, nullptr};
}

#define STAGE_PARAMS                                                        \
  const void *tri_pack, const void *rays, const void *order_g,             \
      const void *n_cand, const void *entry, void *occ, void *best_t,      \
      void *best_id, void *k_io, void *act, void *work, int size,          \
      int kgroups, int g, int s, int t_lanes, int n_clusters,              \
      int entry_stride, int threshold, int any_hit, int w, void *stream
#define STAGE_ARGS                                                          \
  stage_args(tri_pack, rays, order_g, n_cand, entry, occ, best_t, best_id, \
             k_io, act, work, size, kgroups, g, s, t_lanes, n_clusters,    \
             entry_stride, threshold, w)

// One stage of the cascade (see above) on `stream`: any_hit 1 with occ,
// 0 (first-slot closest) with entry, best_t and best_id; w warps a slot;
// work: 14 + 4 size 32-bit words, the first 14 + 2 size zero.
// Returns the cudaError_t of the launch (0 = ok), or NO_INSTANCE for an
// (S, T) that is not compiled.
extern "C" int cascade_stage(STAGE_PARAMS) {
  if (size <= 0) return 0;
  if (g < 1 || kgroups < 1 || !stage_split_ok(w)) {
    return (int)cudaErrorInvalidValue;
  }
#define LAUNCH(S_, T_)                                                 \
  if (s == S_ && t_lanes == T_)                                        \
    return any_hit                                                     \
               ? launch_stage<TileAny, S_, T_>(STAGE_ARGS,             \
                                               (cudaStream_t)stream)   \
               : launch_stage<TileFirst, S_, T_>(STAGE_ARGS,           \
                                                 (cudaStream_t)stream);
  FOR_STAGE_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// The generic instance of cascade_stage, with its arguments, for any
// S, T >= 1.
extern "C" int cascade_stage_generic(STAGE_PARAMS) {
  if (size <= 0) return 0;
  if (g < 1 || kgroups < 1 || s < 1 || t_lanes < 1 || !stage_split_ok(w)) {
    return (int)cudaErrorInvalidValue;
  }
  return any_hit
             ? launch_stage<TileAny, 0, 0>(STAGE_ARGS, (cudaStream_t)stream)
             : launch_stage<TileFirst, 0, 0>(STAGE_ARGS, (cudaStream_t)stream);
}

// Registers per thread and resident warps per SM of the (S, T) instance
// (S = 0: the generic one).
extern "C" int cascade_stage_occupancy(int s, int t_lanes, int any_hit,
                                       int* regs, int* warps_per_sm) {
  if (s == 0) {
    return any_hit ? stage_occupancy<TileAny, 0, 0>(regs, warps_per_sm)
                   : stage_occupancy<TileFirst, 0, 0>(regs, warps_per_sm);
  }
#define OCCUPANCY(S_, T_)                                              \
  if (s == S_ && t_lanes == T_)                                        \
    return any_hit ? stage_occupancy<TileAny, S_, T_>(regs, warps_per_sm) \
                   : stage_occupancy<TileFirst, S_, T_>(regs, warps_per_sm);
  FOR_STAGE_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// Counts, over the 2^32 bit patterns, the x in rcp_fast's range whose
// rcp_fast(x) differs in any bit from 1.0f / x (one atomic add per thread
// that found some).
__global__ void rcp_check_kernel(unsigned long long* mismatches) {
  const unsigned stride = gridDim.x * blockDim.x;  // 2^20: 4096 trips each
  unsigned bits = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long bad = 0;
  for (unsigned k = 0; k < (1ull << 32) / stride; ++k, bits += stride) {
    const float x = __uint_as_float(bits);
    const float ax = fabsf(x);
    if (!(ax >= 1.17549435e-38f && ax < RCP_FAST_BELOW)) continue;
    if (__float_as_uint(rcp_fast(x)) != __float_as_uint(1.0f / x)) ++bad;
  }
  if (bad) atomicAdd(mismatches, bad);
}

// Mismatches between mt.cuh's rcp_fast(x) and 1.0f / x over every float bit
// pattern in rcp_fast's range, written to *mismatches (a zeroed u64 on the
// device).
extern "C" int rcp_check(void* mismatches, void* stream) {
  rcp_check_kernel<<<4096, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)mismatches);
  return (int)cudaGetLastError();
}
