// Any-hit of one ray block against GROUP candidate clusters, for Hopper
// (sm_90a): the sweep body of the fused shadow cascade.
//
// Replaces the TPU kernel path_tracer_ai_tpu/accel/pallas_anyhit.py
// `block_anyhit` (`_anyhit_kernel`). Block i of T rays is tested against
// the clusters cid8[i*8 .. i*8+7]; a lane is occluded when any triangle of
// any of them passes its Möller–Trumbore test within [t_min, t_max].
//
// Layouts (see accel/cuda_anyhit.py):
//   tri_pack [C+1, 16, S] f32 (pack_tris_dummy): rows 0-8 v0 e1 e2, row 9
//            tri id, rows 10-15 the sub-slab boxes at lanes 0..ns-1;
//            cluster C is the all-zero dummy with inverted boxes.
//   rays     [size, 8, T] f32: ox oy oz dx dy dz t_max t_min.
//   cid8     [size * 8] i32, values in [0, C].
//   occ      [size, T] u8 0/1. (The TPU kernel's [size, 8, T] f32 output
//            with seven unused rows was Mosaic's block shape, not needed.)
//
// Options, both gates that never change the result:
//   early_skip  a warp skips the remaining candidates once each of its 32
//               lanes is occluded or dead, and skips the dummy candidate;
//   sub_skip    a 32-triangle sub-slab is swept only if some lane of the
//               warp that is still open has a [t_min, t_max] segment that
//               touches its box.
// Both are finer than the plain version's block-wide gates (a warp in
// place of the T lanes, open lanes in place of all); a lane skips only
// tests it cannot pass or no longer needs, so every output bit stays.
//
// Design (the inner loop is mt.cuh's anyhit_run; the layout of the work is
// fused_closest.cu's). A ray block is split over T / 32 warps of one ray a
// thread that share nothing: four warps a thread block, no __syncthreads.
// Each warp reads the eight ids once (one lane each), walks the candidates
// through a ballot, and stages each one for itself with cp.async (mt.cuh
// stage_candidate, as fused_closest.cu: S transposed triangles and the
// sub-slab boxes; staging only the sub-slabs the gate lets through measured
// no faster). Whatever the options, the warp leaves a candidate as soon as
// each of its lanes is occluded or dead (a vote before each sub-slab).
//
// What bounds it: instruction issue where anything is swept (mt.cuh: about
// 70 instructions a test, and under --fmad=false about twice the operations
// term of the bound at best); how much is swept depends on the data. Build
// with --fmad=false (see mt.cuh).

#include "mt.cuh"
#include "stage.cuh"

#define GROUP 8
#define PACK_ROWS 16
// Thread blocks an SM must hold: 8 caps the kernel at 64 registers, 32
// resident warps at S = 128; left at 79 registers it holds 24 and ran
// slower (PERF.md).
#define ANYHIT_MIN_BLOCKS 8

template <int S, int T>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, ANYHIT_MIN_BLOCKS)
    block_anyhit_kernel(const float* __restrict__ tri_pack,
                        const float* __restrict__ rays,
                        const int* __restrict__ cid8,
                        unsigned char* __restrict__ occ_out, int size,
                        int dummy, int early_skip, int sub_skip) {
  constexpr int NS = S / SUB;
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
  const bool dead = !(tmax >= tmin);  // can pass no test
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;
  bool occ = false;

  // Lane j < GROUP holds candidate j; `todo` has a bit per candidate to
  // walk (none if every lane of the warp is dead).
  const int my_cid = lane < GROUP ? cid8[blk * GROUP + lane] : dummy;
  unsigned todo = __ballot_sync(
      FULL_MASK, lane < GROUP && !(early_skip && my_cid >= dummy));
  if (__all_sync(FULL_MASK, dead)) todo = 0u;

  while (todo != 0u) {
    if (early_skip && __all_sync(FULL_MASK, occ || dead)) break;
    const int cid = __shfl_sync(FULL_MASK, my_cid, __ffs(todo) - 1);
    todo &= todo - 1u;
    stage_candidate<S>(st, tri_pack + (size_t)cid * PACK_ROWS * S, lane);
    cp_async_wait_all();
    __syncwarp();
#pragma unroll 1
    for (int k = 0; k < NS; ++k) {
      const bool open = !(occ || dead);
      if (!__any_sync(FULL_MASK, open)) break;
      if (sub_skip) {
        const float4 lo =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS);
        const float4 hi =
            *reinterpret_cast<const float4*>(st->box + k * BOX_WORDS + 4);
        const float box[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
        const bool touch =
            open && sub_slab_lane(box, ray, invx, invy, invz, tmin, tmax);
        if (!__any_sync(FULL_MASK, touch)) continue;
      }
      occ = anyhit_run<SUB>(st->tri + k * SUB, ray, tmin, tmax, dead, occ);
    }
    __syncwarp();  // every lane is done with the buffer
  }
  occ_out[blk * T + off] = occ ? 1 : 0;
}

template <int S>
constexpr size_t smem_bytes() {
  return SWEEP_WARPS * sizeof(Staged<S>);
}

// Allows the kernel its dynamic shared memory (above the default 48 KB at
// S = 256) on the current device.
template <int S, int T>
static cudaError_t configure() {
  return cudaFuncSetAttribute(block_anyhit_kernel<S, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<S>());
}

template <int S, int T>
static int launch(const void* tri_pack, const void* rays, const void* cid8,
                  void* occ, int size, int dummy, int early_skip,
                  int sub_skip, cudaStream_t stream) {
  const cudaError_t err = configure<S, T>();
  if (err != cudaSuccess) return (int)err;
  const int units = size * (T / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  block_anyhit_kernel<S, T>
      <<<blocks, SWEEP_WARPS * 32, smem_bytes<S>(), stream>>>(
          (const float*)tri_pack, (const float*)rays, (const int*)cid8,
          (unsigned char*)occ, size, dummy, early_skip, sub_skip);
  return (int)cudaGetLastError();
}

template <int S, int T>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaError_t err = configure<S, T>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_anyhit_kernel<S, T>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_anyhit_kernel<S, T>, SWEEP_WARPS * 32, smem_bytes<S>());
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_INSTANCES(CALL)                                             \
  CALL(64, 64) CALL(64, 128) CALL(128, 64) CALL(128, 128) CALL(256, 64) \
  CALL(256, 128)

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok), or
// NO_INSTANCE for an (S, T) that is not compiled.
extern "C" int block_anyhit(const void* tri_pack, const void* rays,
                            const void* cid8, void* occ, int size, int s,
                            int t_lanes, int dummy, int early_skip,
                            int sub_skip, void* stream) {
  if (size <= 0) return 0;
#define LAUNCH(S_, T_)                                                  \
  if (s == S_ && t_lanes == T_)                                         \
    return launch<S_, T_>(tri_pack, rays, cid8, occ, size, dummy,       \
                          early_skip, sub_skip, (cudaStream_t)stream);
  FOR_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, T) instance and the warps an SM holds of
// it.
extern "C" int block_anyhit_occupancy(int s, int t_lanes, int* regs,
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
// candidate is walked sub-slab by sub-slab with the tuned instances' votes
// and gates (the box read from the pack's rows 10-15); a sub-slab that
// passes them is staged (mt.cuh stage_chunk_warp, zeros past S) and swept by
// anyhit_run<32>, the tuned instances' loop. The same bits.
// The generic sweep body of one warp (32 lanes of a ray block) against a
// block's GROUP candidates, lane j < GROUP holding candidate j in my_cid
// (the others the dummy): each candidate walked sub-slab by sub-slab, a
// sub-slab that passes the gates staged into buf (CHUNK TriRecs) and swept
// by anyhit_run<CHUNK>; the lane's occlusion ORed with that of every
// candidate. `occ` may come in true (the stage fold FusedAny starts from
// its carry; an OR changes no bit). Shared by block_anyhit_generic_kernel
// and FusedAny, so both run this code.
__device__ __forceinline__ bool anyhit_group_generic(
    TriRec* buf, const float* __restrict__ tri_pack, int s, int my_cid,
    int dummy, const Ray& ray, float tmin, float tmax, bool dead, bool occ,
    int early_skip, int sub_skip, int lane) {
  const int ns = (s + SUB - 1) / SUB;
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;
  unsigned todo = __ballot_sync(
      FULL_MASK, lane < GROUP && !(early_skip && my_cid >= dummy));
  if (__all_sync(FULL_MASK, dead)) todo = 0u;

  while (todo != 0u) {
    if (early_skip && __all_sync(FULL_MASK, occ || dead)) break;
    const int cid = __shfl_sync(FULL_MASK, my_cid, __ffs(todo) - 1);
    todo &= todo - 1u;
    const float* cluster = tri_pack + (size_t)cid * PACK_ROWS * s;
#pragma unroll 1
    for (int k = 0; k < ns; ++k) {
      const bool open = !(occ || dead);
      if (!__any_sync(FULL_MASK, open)) break;
      if (sub_skip) {
        float box[6];
        load_box(cluster, s, k, box);
        const bool touch =
            open && sub_slab_lane(box, ray, invx, invy, invz, tmin, tmax);
        if (!__any_sync(FULL_MASK, touch)) continue;
      }
      stage_chunk_warp<10>(buf, cluster, s, k * SUB, lane);
      cp_async_wait_all();
      __syncwarp();
      occ = anyhit_run<CHUNK>(buf, ray, tmin, tmax, dead, occ);
      __syncwarp();  // every lane is done with the buffer
    }
  }
  return occ;
}

__global__ void __launch_bounds__(SWEEP_WARPS * 32, ANYHIT_MIN_BLOCKS)
    block_anyhit_generic_kernel(const float* __restrict__ tri_pack,
                                const float* __restrict__ rays,
                                const int* __restrict__ cid8,
                                unsigned char* __restrict__ occ_out, int size,
                                int dummy, int early_skip, int sub_skip,
                                int s, int t_lanes) {
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
  const bool dead = !(tmax >= tmin);  // can pass no test
  const int my_cid = lane < GROUP ? cid8[blk * GROUP + lane] : dummy;
  const bool occ = anyhit_group_generic(bufs[warp], tri_pack, s, my_cid,
                                        dummy, ray, tmin, tmax, dead, false,
                                        early_skip, sub_skip, lane);
  if (off < t_lanes) occ_out[blk * t_lanes + off] = occ ? 1 : 0;
}

// block_anyhit's generic instance, with its arguments, for any S, T >= 1.
extern "C" int block_anyhit_generic(const void* tri_pack, const void* rays,
                                    const void* cid8, void* occ, int size,
                                    int s, int t_lanes, int dummy,
                                    int early_skip, int sub_skip,
                                    void* stream) {
  if (size <= 0) return 0;
  if (s < 1 || t_lanes < 1) return (int)cudaErrorInvalidValue;
  const int units = size * ((t_lanes + 31) / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  block_anyhit_generic_kernel<<<blocks, SWEEP_WARPS * 32, 0,
                                (cudaStream_t)stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid8,
      (unsigned char*)occ, size, dummy, early_skip, sub_skip, s, t_lanes);
  return (int)cudaGetLastError();
}

// ---- the fused any-hit cascade's stage: one stage as one launch ------------
//
// The fused shadow cascade's loop (any_hit_fused, traverse._cascade_stages)
// runs each stage as one cooperative launch of stage.cuh's kernel with this
// fold: the rule and sweep set of any hit (act = k g < n_cand & some lane
// neither occluded nor dead), and as the sweep of a listed block's slot the
// body of block_anyhit's generic instance, anyhit_group_generic, over its
// group min(k, kgroups - 1) with the early_skip and sub_skip gates, from
// the slot's carried occlusion. One warp a slot (W = 1); one instance, S
// and T at run time: each warp stages only the sub-slabs its gates pass
// into its own CHUNK TriRecs (an instance at (S 128, T 128) that staged
// each candidate whole was 8-30% slower on every sweeping stage, PERF.md
// §6). Candidate ids are read through stage_cid, which counts an id
// outside [0, C] and sweeps the dummy in its place. The bits are those of
// block_anyhit launched on the stage's active blocks once an iteration,
// ORed into the carry.
struct FusedAny {
  static constexpr bool ANY = true;
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
    const bool dead = !(tmax >= tmin);  // can pass no test
    bool occ = in && __ldcg(a.occ + ci) != 0;
    occ = anyhit_group_generic(reinterpret_cast<TriRec*>(buf), a.tri_pack,
                               a.s, my_cid, a.n_clusters, ray, tmin, tmax,
                               dead, occ, a.opts & STAGE_EARLY_SKIP,
                               a.opts & STAGE_SUB_SKIP, lane);
    if (in) a.occ[ci] = occ ? 1 : 0;
    return __any_sync(FULL_MASK, !occ && !(tmax < 0.0f)) ? 1u : 0u;
  }
};

// One stage of the fused any-hit cascade on `stream`, for any S, T >= 1:
// tri_pack [C+1, 16, S] (dummy = C), rays [size, 8, T], order_g [size,
// kgroups, 8], n_cand [size], occ [size, T] u8 (the carry), k_io [1], act
// [size] u8; work: 14 + 4 size 32-bit words, the first 14 + 2 size zero;
// err [3] i32 (0, INT32_MAX, INT32_MIN before the cascade's first stage).
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int fused_stage_any(const void* tri_pack, const void* rays,
                               const void* order_g, const void* n_cand,
                               void* occ, void* k_io, void* act, void* work,
                               void* err, int size, int kgroups, int s,
                               int t_lanes, int dummy, int threshold,
                               int early_skip, int sub_skip, void* stream) {
  if (size <= 0) return 0;
  if (kgroups < 1 || s < 1 || t_lanes < 1) return (int)cudaErrorInvalidValue;
  unsigned* words = (unsigned*)work;
  const StageArgs a{(const float*)tri_pack, (const float*)rays,
                    (const int*)order_g, (const int*)n_cand, nullptr,
                    (unsigned char*)occ, nullptr, nullptr, (int*)k_io,
                    (unsigned char*)act, (unsigned long long*)words,
                    words + STAGE_SYNC_WORDS, words + STAGE_SYNC_WORDS + size,
                    (int*)(words + STAGE_SYNC_WORDS + 2 * (size_t)size),
                    size, kgroups, GROUP, s, t_lanes, dummy, 0, threshold, 1,
                    (early_skip ? STAGE_EARLY_SKIP : 0) |
                        (sub_skip ? STAGE_SUB_SKIP : 0),
                    (int*)err};
  return launch_stage<FusedAny, 0, 0>(a, (cudaStream_t)stream);
}

// Registers per thread and resident warps per SM of the stage fold.
extern "C" int fused_stage_any_occupancy(int* regs, int* warps_per_sm) {
  return stage_occupancy<FusedAny, 0, 0>(regs, warps_per_sm);
}
