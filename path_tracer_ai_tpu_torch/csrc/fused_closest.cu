// Closest hit of one ray block against GROUP entry-ordered candidate
// clusters, for Hopper (sm_90a): the sweep body of the fused closest
// cascade.
//
// Replaces the TPU kernel path_tracer_ai_tpu/accel/pallas_closest.py
// `block_closest` (`_closest_kernel`). Block i of T rays is tested against
// the clusters cid8[i*8 .. i*8+7] in order; each lane keeps a running
// (t, tri) with the oracle's lexicographic rule (smaller t, then smaller
// triangle id; tests pass with t <= min(t_max, running best), inclusive).
//
// Layouts (see accel/cuda_closest.py): tri_pack, rays and cid8 as in
// fused_anyhit.cu (ray row 6 carries min(t_max, best so far of the
// cascade)); outputs t [size, T] f32 (inf = miss) and tri [size, T] i32
// (INT32_MAX = none), in place of the TPU kernel's [size, 8, T] f32 block
// with the id bit-cast into row 1.
//
// Option sub_skip: a 32-triangle sub-slab is swept only if some lane's
// [t_min, min(t_max, running best)] segment touches its box, grown by a few
// hundred ulps of its coordinates (mt.cuh gate_lane), and a lane takes its
// hits only where its own segment does; the bound is re-read before every
// sub-slab, so hits in near sub-slabs prune far ones inside one call. The
// dummy cluster (id C) is always skipped.
//
// Design (the inner loop is mt.cuh's, shared with ctiles_sweep.cu). A ray
// block is split over T / 32 warps of one ray per thread (running (t, tri)
// in registers) that share nothing: four warps a thread block, no
// __syncthreads. Each warp reads the eight ids once (one lane each), walks
// the real candidates through a ballot, and stages each candidate for
// itself with cp.async (mt.cuh stage_candidate): S transposed triangles
// (TriRec) and the sub-slab boxes (pack rows 10-15), 6.3 KB at
// S = 128, which lets an SM hold 32 warps. The gate is the warp's: each lane
// evaluates each box once, just before its sub-slab, with its bound of that
// moment, and one __any_sync over the warp's 32 lanes decides. That is finer
// than the plain version's vote over all T lanes, so fewer sub-slabs are
// swept; the result is the same bit for bit, because a lane whose own gate
// fails sweeps the sub-slab with its window closed. Inside a sub-slab the warp votes once
// more per triangle, after u (mt.cuh sweep_run): with one ray a thread no
// lane has 0 <= u <= 1 for most triangles, and v and t are then not
// computed.
//
// Why the unit of work is a warp of 32 lanes and not the ray block: the
// launch lasts as long as the unit that skips least, and small units with
// their own gates spread that work; one buffer per warp, because a second
// one with the next candidate on its way costs more in resident warps than
// it hides (both measured, PERF.md).
//
// What bounds it: instruction issue where anything is swept (see mt.cuh:
// about 70 instructions a test, and with --fmad=false about twice the
// operations term of the bound at best); the number of sub-slabs swept
// depends on the data. Build with --fmad=false (see mt.cuh).

#include "mt.cuh"
#include "stage.cuh"

#define GROUP 8
#define PACK_ROWS 16

template <int S, int T>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    block_closest_kernel(const float* __restrict__ tri_pack,
                         const float* __restrict__ rays,
                         const int* __restrict__ cid8,
                         float* __restrict__ t_out, int* __restrict__ tri_out,
                         int size, int dummy, int sub_skip) {
  constexpr int NS = (S + SUB - 1) / SUB;
  constexpr int WPB = T / 32;  // warps per ray block
  static_assert(S % SUB == 0, "whole sub-slabs only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= size * WPB) return;  // whole warps leave: no block barrier
  const size_t blk = (size_t)(unit / WPB);
  const int off = (unit % WPB) * 32 + lane;  // this thread's lane of T
  Staged<S>* st = reinterpret_cast<Staged<S>*>(smem) + warp;

  const float* rp = rays + blk * RAY_ROWS * T + off;
  const Ray ray = load_ray(rp, T);
  const float tmax = rp[6 * T], tmin = rp[7 * T];
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;
  float best_t = INFINITY;
  int best_tri = I32_MAX;

  // Lane j < GROUP holds candidate j; `todo` has a bit per real candidate
  // (none if every lane of the warp is dead and can pass no test).
  const int my_cid = lane < GROUP ? cid8[blk * GROUP + lane] : dummy;
  unsigned todo = __ballot_sync(FULL_MASK, my_cid >= 0 && my_cid < dummy);
  if (!__any_sync(FULL_MASK, tmax >= tmin)) todo = 0u;

  while (todo != 0u) {
    const int cid = __shfl_sync(FULL_MASK, my_cid, __ffs(todo) - 1);
    todo &= todo - 1u;
    stage_candidate<S>(st, tri_pack + (size_t)cid * PACK_ROWS * S, lane);
    cp_async_wait_all();
    __syncwarp();
#pragma unroll 1
    for (int k = 0; k < NS; ++k) {
      float cap = fminf(tmax, best_t);
      if (sub_skip) {
        const float4 lo =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS);
        const float4 hi =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS + 4);
        const float box[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
        const bool touch = gate_lane(box, ray, invx, invy, invz, tmin, cap);
        if (!__any_sync(FULL_MASK, touch)) continue;
        if (!touch) cap = -INFINITY;  // its own gate failed: no test passes
      }
      sweep_run<1, SUB>(st->tri + k * SUB, &ray, &tmin, &cap, &best_t,
                        &best_tri);
    }
    __syncwarp();  // every lane is done with the buffer
  }
  t_out[blk * T + off] = best_t;
  tri_out[blk * T + off] = best_tri;
}

template <int S>
constexpr size_t smem_bytes() {
  return SWEEP_WARPS * sizeof(Staged<S>);
}

// Allows the kernel its dynamic shared memory (above the default 48 KB at
// S = 256) on the current device.
template <int S, int T>
static cudaError_t configure() {
  return cudaFuncSetAttribute(block_closest_kernel<S, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<S>());
}

template <int S, int T>
static int launch(const void* tri_pack, const void* rays, const void* cid8,
                  void* t_out, void* tri_out, int size, int dummy,
                  int sub_skip, cudaStream_t stream) {
  const cudaError_t err = configure<S, T>();
  if (err != cudaSuccess) return (int)err;
  const int units = size * (T / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  block_closest_kernel<S, T>
      <<<blocks, SWEEP_WARPS * 32, smem_bytes<S>(), stream>>>(
          (const float*)tri_pack, (const float*)rays, (const int*)cid8,
          (float*)t_out, (int*)tri_out, size, dummy, sub_skip);
  return (int)cudaGetLastError();
}

template <int S, int T>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaError_t err = configure<S, T>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_closest_kernel<S, T>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_closest_kernel<S, T>, SWEEP_WARPS * 32, smem_bytes<S>());
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_INSTANCES(CALL)                                             \
  CALL(64, 64) CALL(64, 128) CALL(128, 64) CALL(128, 128) CALL(256, 64) \
  CALL(256, 128)

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok), or
// NO_INSTANCE for an (S, T) that is not compiled.
extern "C" int block_closest(const void* tri_pack, const void* rays,
                             const void* cid8, void* t_out, void* tri_out,
                             int size, int s, int t_lanes, int dummy,
                             int sub_skip, void* stream) {
  if (size <= 0) return 0;
#define LAUNCH(S_, T_)                                                      \
  if (s == S_ && t_lanes == T_)                                             \
    return launch<S_, T_>(tri_pack, rays, cid8, t_out, tri_out, size, dummy, \
                          sub_skip, (cudaStream_t)stream);
  FOR_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, T) instance and the warps an SM holds of
// it.
extern "C" int block_closest_occupancy(int s, int t_lanes, int* regs,
                                       int* warps_per_sm) {
#define OCCUPANCY(S_, T_) \
  if (s == S_ && t_lanes == T_) return occupancy<S_, T_>(regs, warps_per_sm);
  FOR_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the generic instance: any S, any T (mt.cuh CHUNK) ---------------------
//
// For the (S, T) that no instance above is compiled for: S >= 1 and T >= 1
// at run time, ceil(T / 32) warps a ray block (lanes past T are dead). Each
// candidate is walked sub-slab by sub-slab: the gate reads the sub-slab's
// box from the pack (rows 10-15), and only a sub-slab that passes it is
// staged (mt.cuh stage_chunk_warp, zeros past S) and swept by
// sweep_run<1, 32>, the tuned instances' loop. The same bits.
// closest_group for S at run time: each candidate walked sub-slab by
// sub-slab, a sub-slab that passes the gate staged into buf (CHUNK TriRecs)
// and swept by sweep_run<1, CHUNK>. Shared by block_closest_generic_kernel
// and the stage fold FusedClosest, so both run this code.
__device__ __forceinline__ void closest_group_generic(
    TriRec* buf, const float* __restrict__ tri_pack, int s, int my_cid,
    int dummy, const Ray& ray, float tmin, float tmax, int sub_skip, int lane,
    float* best_t_out, int* best_tri_out) {
  const int ns = (s + SUB - 1) / SUB;
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;
  float best_t = INFINITY;
  int best_tri = I32_MAX;
  unsigned todo = __ballot_sync(FULL_MASK, my_cid >= 0 && my_cid < dummy);
  if (!__any_sync(FULL_MASK, tmax >= tmin)) todo = 0u;

  while (todo != 0u) {
    const int cid = __shfl_sync(FULL_MASK, my_cid, __ffs(todo) - 1);
    todo &= todo - 1u;
    const float* cluster = tri_pack + (size_t)cid * PACK_ROWS * s;
#pragma unroll 1
    for (int k = 0; k < ns; ++k) {
      float cap = fminf(tmax, best_t);
      if (sub_skip) {
        float box[6];
        load_box(cluster, s, k, box);
        const bool touch = gate_lane(box, ray, invx, invy, invz, tmin, cap);
        if (!__any_sync(FULL_MASK, touch)) continue;
        if (!touch) cap = -INFINITY;  // its own gate failed: no test passes
      }
      stage_chunk_warp<10>(buf, cluster, s, k * SUB, lane);
      cp_async_wait_all();
      __syncwarp();
      sweep_run<1, CHUNK>(buf, &ray, &tmin, &cap, &best_t, &best_tri);
      __syncwarp();  // every lane is done with the buffer
    }
  }
  *best_t_out = best_t;
  *best_tri_out = best_tri;
}

__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    block_closest_generic_kernel(const float* __restrict__ tri_pack,
                                 const float* __restrict__ rays,
                                 const int* __restrict__ cid8,
                                 float* __restrict__ t_out,
                                 int* __restrict__ tri_out, int size,
                                 int dummy, int sub_skip, int s,
                                 int t_lanes) {
  __shared__ TriRec bufs[SWEEP_WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = (t_lanes + 31) >> 5;  // warps per ray block
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= size * wpb) return;  // whole warps leave: no block barrier
  const size_t blk = (size_t)(unit / wpb);
  const int off = (unit % wpb) * 32 + lane;

  float tmin, tmax;
  const Ray ray =
      load_lane(rays + blk * RAY_ROWS * t_lanes, t_lanes, off, &tmin, &tmax);
  const int my_cid = lane < GROUP ? cid8[blk * GROUP + lane] : dummy;
  float best_t;
  int best_tri;
  closest_group_generic(bufs[warp], tri_pack, s, my_cid, dummy, ray, tmin,
                        tmax, sub_skip, lane, &best_t, &best_tri);
  if (off < t_lanes) {
    t_out[blk * t_lanes + off] = best_t;
    tri_out[blk * t_lanes + off] = best_tri;
  }
}

// block_closest's generic instance, with its arguments, for any S, T >= 1.
extern "C" int block_closest_generic(const void* tri_pack, const void* rays,
                                     const void* cid8, void* t_out,
                                     void* tri_out, int size, int s,
                                     int t_lanes, int dummy, int sub_skip,
                                     void* stream) {
  if (size <= 0) return 0;
  if (s < 1 || t_lanes < 1) return (int)cudaErrorInvalidValue;
  const int units = size * ((t_lanes + 31) / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  block_closest_generic_kernel<<<blocks, SWEEP_WARPS * 32, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid8,
      (float*)t_out, (int*)tri_out, size, dummy, sub_skip, s, t_lanes);
  return (int)cudaGetLastError();
}

// ---- the fused closest cascade's stage: one stage as one launch ------------
//
// The fused closest cascade's loop (closest_hit_fused,
// traverse._cascade_stages) runs each stage as one cooperative launch of
// stage.cuh's kernel with this fold: the rule and sweep set of closest hit
// (act = k g < n_cand & entry[b, min(k, kgroups - 1) g] <= the largest best
// t of a live lane; swept: every block with k g < n_cand, as the JAX
// package's body sweeps its whole slice), and as the sweep of a listed
// block's slot the body of block_closest's generic instance,
// closest_group_generic, over its group min(k,
// kgroups - 1) with sub_skip, on the window [t_min, torch.minimum(t_max,
// best_t)], from (INFINITY, I32_MAX), then combined into the carry by
// cuda_ctiles.combine_min_tri's rule (the lexicographic (t, least tri),
// the oracle's): the bits of block_closest launched on those blocks once an
// iteration and combined on the card by torch. One warp a slot (W = 1);
// one instance, S and T at run time: each warp stages only the sub-slabs
// its gate passes into its own CHUNK TriRecs (closest_group_generic; an
// instance at (S 128, T 128) that staged each candidate whole was 8-30%
// slower on every sweeping stage, PERF.md §6). Candidate ids are read
// through stage_cid.

// torch.minimum on the card: NaN if either is NaN, else fminf.
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

struct FusedClosest : PacketRule<false> {
  template <int S>
  __host__ __device__ static constexpr size_t warp_bytes() {
    return (size_t)CHUNK * sizeof(TriRec);
  }
  template <int S, int T>
  static __device__ __forceinline__ unsigned sweep(
      const StageArgs& a, StageShared&, int b, int slot, int k, int, int,
      int, int, int lane, unsigned char* buf) {
    const int off = slot * 32 + lane;
    const int my_cid = stage_cid(a, b, k, lane);
    float tmin, tmax;
    const Ray ray = load_lane(a.rays + (size_t)b * RAY_ROWS * a.t_lanes,
                              a.t_lanes, off, &tmin, &tmax);
    const bool in = off < a.t_lanes;
    const size_t ci = (size_t)b * a.t_lanes + off;
    const float bt = in ? __ldcg(a.best_t + ci) : INFINITY;
    const int bid = in ? __ldcg(a.best_id + ci) : I32_MAX;
    // the window's end shrinks to the running best; dead lanes stay < 0
    const float cap = torch_minimum(tmax, bt);
    float kt;
    int ktri;
    closest_group_generic(reinterpret_cast<TriRec*>(buf), a.tri_pack, a.s,
                          my_cid, a.n_clusters, ray, tmin, cap,
                          a.opts & STAGE_SUB_SKIP, lane, &kt, &ktri);
    // combine_min_tri(best, kernel's)
    const float t_new = torch_minimum(bt, kt);
    const int id_a = bt <= t_new ? bid : I32_MAX;
    const int id_b = kt <= t_new ? ktri : I32_MAX;
    const int id_new = id_a < id_b ? id_a : id_b;
    if (in) {
      a.best_t[ci] = t_new;
      a.best_id[ci] = id_new;
    }
    return __reduce_max_sync(FULL_MASK,
                             order_key(tmax < 0.0f ? -INFINITY : t_new));
  }
};

// One stage of the fused closest cascade on `stream`, for any S, T >= 1:
// tri_pack [C+1, 16, S] (dummy = C), rays [size, 8, T], order_g [size,
// kgroups, 8], n_cand [size], entry [size, entry_stride] f32, best_t
// [size, T] f32 and best_id [size, T] i32 (the carry), k_io [1], act
// [size] u8; work and err as fused_stage_any's. Returns the cudaError_t of
// the launch (0 = ok).
extern "C" int fused_stage_closest(const void* tri_pack, const void* rays,
                                   const void* order_g, const void* n_cand,
                                   const void* entry, void* best_t,
                                   void* best_id, void* k_io, void* act,
                                   void* work, void* err, int size,
                                   int kgroups, int s, int t_lanes, int dummy,
                                   int entry_stride, int threshold,
                                   int sub_skip, void* stream) {
  if (size <= 0) return 0;
  if (kgroups < 1 || s < 1 || t_lanes < 1) return (int)cudaErrorInvalidValue;
  unsigned* words = (unsigned*)work;
  const StageArgs a{(const float*)tri_pack, (const float*)rays,
                    (const int*)order_g, (const int*)n_cand,
                    (const float*)entry, nullptr, (float*)best_t,
                    (int*)best_id, (int*)k_io, (unsigned char*)act,
                    (unsigned long long*)words, words + STAGE_SYNC_WORDS,
                    words + STAGE_SYNC_WORDS + size,
                    (int*)(words + STAGE_SYNC_WORDS + 2 * (size_t)size),
                    size, kgroups, GROUP, s, t_lanes, dummy, entry_stride,
                    threshold, 1, sub_skip ? STAGE_SUB_SKIP : 0, (int*)err};
  return launch_stage<FusedClosest, 0, 0>(a, (cudaStream_t)stream);
}

// Registers per thread and resident warps per SM of the stage fold.
extern "C" int fused_stage_closest_occupancy(int* regs, int* warps_per_sm) {
  return stage_occupancy<FusedClosest, 0, 0>(regs, warps_per_sm);
}
