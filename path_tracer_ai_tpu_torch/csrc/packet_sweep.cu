// Per-block candidate walks of the `pallas` backend for Hopper (sm_90a).
//
// Replaces the TPU kernels of path_tracer_ai_tpu/accel/pallas_sweep.py:
// `closest_sweep_pallas` (`_closest_kernel`) and `anyhit_sweep_pallas`
// (`_anyhit_kernel`). Every block of R rays walks ITS OWN list of candidate
// clusters, front to back, inside the kernel, and stops as soon as it is
// done (the closest walk block by block, the any-hit walk warp by warp), so
// one launch serves a whole wave and the host reads nothing back.
//
// Layouts (see accel/cuda_sweep.py):
//   slab   [C, 9, S] f32: v0.xyz, e1.xyz, e2.xyz rows of each cluster.
//   rays   [B, 8, R] f32: rows ox oy oz dx dy dz t_cap (row 7 unused; the
//          window's t_min is the scalar argument); t_cap < 0 marks a dead
//          lane.
//   order  [B, C_pad] i32 candidate cluster ids by ascending entry bound.
//   entry  [B, C_pad] f32 those bounds (closest only).
//   n_cand [B] i32 candidates per block.
//   closest: best_t [B, R] f32 (inf = miss), best_cid [B, R] i32 (-1 =
//            none), best_slot [B, R] i32; any-hit: occ [B, R] u8 0/1.
//
// closest_sweep (the inner loop is mt.cuh's sweep_first, sweep_run's
// twin). One thread block per ray block, one ray a thread, and the walk's
// rule is the ray block's, as the TPU kernel's: go on while k < n_cand and
// entry[k] <= the largest best_t of the block's live lanes (t_cap >= 0;
// lanes past R count as dead), one __syncthreads_or a candidate. A finer
// (per-warp) exit could change a lane whose best_t lies within an ulp of
// entry[k], which is a rounded bound. The walk reads 32 candidate ids and
// entries at a time (one a lane, handed round by __shfl); warp 0 stages
// each candidate transposed with cp.async (TriRec records, 6 KB at
// S = 128). A block's walk is serial, and the longest walk of a wave sets
// its time: on the pallas bench render's primary rays some blocks walk 358
// candidates while the mean is 7. So each visit is spread over more warps:
// up to R = 64 four warp groups (two up to 128) each test a quarter (half)
// of the S triangles for all R lanes, and meet after each visit to take
// each lane's minimum t for the vote; and the wrapper starts the blocks
// longest candidate list first, so that no long walk starts late. A hit
// replaces a lane's best only with t < best, and the parts' bests are
// merged by (t, candidate position, slot): the first slot of the first
// candidate at the minimum wins (the TPU kernel's argmin and `closer`
// rule), which may differ from the oracle's min-tri rule on an exact tie.
// S and the number of parts are template parameters (S in 64, 128, 256).
//
// anyhit_sweep (the inner loop is mt.cuh's anyhit_run). The unit of work is
// a warp of 32 lanes of a ray block (R / 32 of them, rounded up; lanes past
// R are dead), one ray a thread, four warps a thread block that share
// nothing (only __syncwarp). Each warp walks the block's own list front to
// back, reading 32 ids at a time (one a lane, handed round by __shfl), and
// stages each cluster for itself, transposed, with cp.async (nine rows,
// 6 KB at S = 128). It stops once each of its lanes is occluded or dead
// (t_cap < t_min: it can pass no test), and inside a cluster as soon as that
// holds (anyhit_run votes every 32 triangles). The TPU kernel went on while
// any lane of the block was not occluded, so a block that held one dead
// lane walked its whole list; occlusion is an OR of independent tests, so
// the finer exit changes no bit. S is a template parameter (64, 128, 256):
// the loops unroll and every shared-memory address is an immediate. A lane
// whose shadow ray reaches its light is never occluded, so on a wave of
// such rays nearly every warp still walks its whole list: what the kernel
// gains there is its loop's, not its exit's (PERF.md).
//
// What bounds them. A visit of one cluster by one block (any-hit: by one
// warp) is R*S (32*S) tests of ~46 f32 operations against 36*S bytes of
// triangle rows, mostly from L2, plus 8 bytes of order/entry: instruction
// issue, as the tile sweep (about 70 instructions a test, see mt.cuh); the
// number of visits depends on the data. A closest wave whose blocks walk
// few candidates is bound instead by its longest walk: each of its visits
// is a chain of S / P dependent tests a thread. Build with --fmad=false
// (see mt.cuh).

#include "mt.cuh"

#define SLAB_ROWS 9

// Warp groups that split a visit's S triangles between them (P): 4 up to
// R = 64, 2 up to 128, else 1, so that a block has at most eight warps
// while P > 1 (and R / 32, at most 32, at P = 1).
constexpr int closest_parts(int r_lanes) {
  return r_lanes <= 64 ? 4 : r_lanes <= 128 ? 2 : 1;
}

// closest_sweep's arguments (see the layouts above); block_order [B] i32 is
// the order in which the ray blocks are started.
struct ClosestArgs {
  const float* slab;
  const float* rays;
  const int* order;
  const float* entry;
  const int* n_cand;
  const int* block_order;
  float* best_t;
  int* best_cid;
  int* best_slot;
  int r_lanes, c_pad;
  float t_min;
};

// Thread (warp w, lane l) of a block of P * ceil(R / 32) warps keeps ray
// (w mod ceil(R / 32)) * 32 + l and tests the triangles of part
// w / ceil(R / 32), slots [part * S / P, (part + 1) * S / P), of every
// candidate. Its running best is over its part: (t, candidate position k,
// slot). After each visit the parts' t meet in shared memory and each
// thread takes their minimum, its lane's best_t over the whole cluster, for
// the next vote; at the end the parts' bests are merged by (t, k, slot), so
// the first slot of the first candidate at the minimum wins, as in the
// sequential walk. 64 registers at most (32 warps an SM).
template <int S, int P>
__global__ void __launch_bounds__(1024, 1)
    closest_sweep_kernel(const ClosestArgs p) {
  constexpr int NP = S / P;  // triangles of a part
  extern __shared__ __align__(16) unsigned char smem[];
  TriRec* buf = reinterpret_cast<TriRec*>(smem);
  const int lanes = blockDim.x / P;  // ceil(R / 32) * 32
  float* part_t = reinterpret_cast<float*>(buf + S);  // [P, lanes] each
  int* part_k = reinterpret_cast<int*>(part_t + P * lanes);
  int* part_slot = part_k + P * lanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = threadIdx.x / lanes;
  const int idx = threadIdx.x % lanes;  // this thread's lane of R
  const size_t blk = p.block_order[blockIdx.x];
  const int r_lanes = p.r_lanes;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float cap = -1.0f;
  if (idx < r_lanes) {
    const float* rp = p.rays + blk * RAY_ROWS * r_lanes + idx;
    ray = load_ray(rp, r_lanes);
    cap = rp[6 * r_lanes];
  }
  const float tmin = p.t_min;
  const bool voter = idx < r_lanes && !(cap < 0.0f);  // live
  // can some lane of the warp pass a test?
  const bool testing = __any_sync(FULL_MASK, cap >= tmin);
  float best_t = INFINITY, merged = INFINITY;
  int best_k = I32_MAX, best_slot = 0;

  const int n_i = p.n_cand[blk];
  const int* my_order = p.order + blk * p.c_pad;
  const float* my_entry = p.entry + blk * p.c_pad;
  bool walking = true;
  for (int k0 = 0; walking && k0 < n_i; k0 += 32) {
    const bool listed = k0 + lane < n_i;
    const int my_cid = listed ? my_order[k0 + lane] : 0;
    const float my_e = listed ? my_entry[k0 + lane] : INFINITY;
    const int n_here = min(32, n_i - k0);
    for (int j = 0; j < n_here; ++j) {
      // Front-to-back stop, the ray block's: entry[k] <= the largest best_t
      // of its live lanes. Also the barrier between the last candidate's
      // tests and reads and this one's staging.
      const float e = __shfl_sync(FULL_MASK, my_e, j);
      if (!__syncthreads_or(voter && e <= merged)) {
        walking = false;
        break;
      }
      const int cid = __shfl_sync(FULL_MASK, my_cid, j);
      if (warp == 0) {
        stage_cluster_warp<S, SLAB_ROWS>(
            buf, p.slab + (size_t)cid * SLAB_ROWS * S, lane);
        cp_async_wait_all();
      }
      __syncthreads();
      if (testing) {
        sweep_first<NP>(buf + part * NP, k0 + j, ray, tmin, cap, best_t,
                        best_k, best_slot);
      }
      if (P == 1) {
        merged = best_t;
      } else {
        part_t[threadIdx.x] = best_t;
        __syncthreads();
        merged = part_t[idx];
#pragma unroll
        for (int q = 1; q < P; ++q) {
          merged = fminf(merged, part_t[q * lanes + idx]);
        }
      }
    }
  }
  if (P > 1) {
    __syncthreads();  // every thread is done reading part_t
    part_t[threadIdx.x] = best_t;
    part_k[threadIdx.x] = best_k;
    part_slot[threadIdx.x] = part * NP + best_slot;
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int q = 1; q < P; ++q) {  // parts in slot order
      const float t = part_t[q * lanes + idx];
      const int k = part_k[q * lanes + idx];
      if (t < best_t || (t == best_t && k < best_k)) {
        best_t = t;
        best_k = k;
        best_slot = part_slot[q * lanes + idx];
      }
    }
  }
  if (idx < r_lanes) {
    const size_t o = blk * r_lanes + idx;
    p.best_t[o] = best_t;
    p.best_cid[o] = best_k == I32_MAX ? -1 : my_order[best_k];
    p.best_slot[o] = best_k == I32_MAX ? 0 : best_slot;
  }
}

template <int S, int P>
constexpr size_t closest_smem_bytes(int threads) {
  return S * sizeof(TriRec) + (P > 1 ? 3 * sizeof(float) * threads : 0);
}

static int closest_threads(int r_lanes) {
  return closest_parts(r_lanes) * 32 * ((r_lanes + 31) / 32);
}

template <int S, int P>
static int closest_launch(const ClosestArgs& p, int b, cudaStream_t stream) {
  const int threads = closest_threads(p.r_lanes);
  closest_sweep_kernel<S, P>
      <<<b, threads, closest_smem_bytes<S, P>(threads), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int S, int P>
static int closest_occupancy(int r_lanes, int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, closest_sweep_kernel<S, P>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  const int threads = closest_threads(r_lanes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, closest_sweep_kernel<S, P>, threads,
      closest_smem_bytes<S, P>(threads));
  *warps_per_sm = blocks * threads / 32;
  return (int)err;
}

// The (S, P) instance for R: launch, or its registers and warps an SM holds.
template <int S>
static int closest_launch_s(const ClosestArgs& p, int b, cudaStream_t stream) {
  switch (closest_parts(p.r_lanes)) {
    case 4:
      return closest_launch<S, 4>(p, b, stream);
    case 2:
      return closest_launch<S, 2>(p, b, stream);
    default:
      return closest_launch<S, 1>(p, b, stream);
  }
}

template <int S>
static int closest_occupancy_s(int r_lanes, int* regs, int* warps_per_sm) {
  switch (closest_parts(r_lanes)) {
    case 4:
      return closest_occupancy<S, 4>(r_lanes, regs, warps_per_sm);
    case 2:
      return closest_occupancy<S, 2>(r_lanes, regs, warps_per_sm);
    default:
      return closest_occupancy<S, 1>(r_lanes, regs, warps_per_sm);
  }
}

template <int S>
__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    anyhit_sweep_kernel(const float* __restrict__ slab,
                        const float* __restrict__ rays,
                        const int* __restrict__ order,
                        const int* __restrict__ n_cand,
                        unsigned char* __restrict__ occ_out, int b,
                        int r_lanes, int c_pad, float t_min) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = (r_lanes + 31) >> 5;  // warps per ray block
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= b * wpb) return;  // whole warps leave: no block barrier
  const size_t blk = (size_t)(unit / wpb);
  const int off = (unit % wpb) * 32 + lane;  // this thread's lane of R
  TriRec* buf = reinterpret_cast<TriRec*>(smem) + (size_t)warp * S;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float t_cap = -1.0f;
  if (off < r_lanes) {
    const float* r = rays + blk * RAY_ROWS * r_lanes + off;
    ray = load_ray(r, r_lanes);
    t_cap = r[6 * r_lanes];
  }
  const bool dead = !(t_cap >= t_min);  // can pass no test
  bool occ = false;
  const int n_i = n_cand[blk];
  const int* my_order = order + blk * c_pad;
  // the inner break ends the outer loop too: its condition votes again
  for (int k0 = 0; k0 < n_i && !__all_sync(FULL_MASK, occ || dead);
       k0 += 32) {
    const int my_cid = k0 + lane < n_i ? my_order[k0 + lane] : 0;
    const int n_here = min(32, n_i - k0);
    for (int j = 0; j < n_here; ++j) {
      if (__all_sync(FULL_MASK, occ || dead)) break;
      const int cid = __shfl_sync(FULL_MASK, my_cid, j);
      stage_cluster_warp<S, SLAB_ROWS>(buf, slab + (size_t)cid * SLAB_ROWS * S,
                                       lane);
      cp_async_wait_all();
      __syncwarp();
      occ = anyhit_run<S>(buf, ray, t_min, t_cap, dead, occ);
      __syncwarp();  // every lane is done with the buffer
    }
  }
  if (off < r_lanes) occ_out[blk * r_lanes + off] = occ ? 1 : 0;
}

template <int S>
constexpr size_t anyhit_smem_bytes() {
  static_assert(SWEEP_WARPS * S * sizeof(TriRec) <= 48 * 1024,
                "the staging buffers exceed the default shared memory");
  return SWEEP_WARPS * S * sizeof(TriRec);
}

template <int S>
static int anyhit_launch(const void* slab, const void* rays, const void* order,
                         const void* n_cand, void* occ, int b, int r_lanes,
                         int c_pad, float t_min, cudaStream_t stream) {
  const int units = b * ((r_lanes + 31) / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  anyhit_sweep_kernel<S>
      <<<blocks, SWEEP_WARPS * 32, anyhit_smem_bytes<S>(), stream>>>(
          (const float*)slab, (const float*)rays, (const int*)order,
          (const int*)n_cand, (unsigned char*)occ, b, r_lanes, c_pad, t_min);
  return (int)cudaGetLastError();
}

template <int S>
static int anyhit_occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, anyhit_sweep_kernel<S>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, anyhit_sweep_kernel<S>, SWEEP_WARPS * 32,
      anyhit_smem_bytes<S>());
  *warps_per_sm = blocks * SWEEP_WARPS;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_SWEEP_INSTANCES(CALL) CALL(64) CALL(128) CALL(256)

// Both launch on `stream` and return the cudaError_t of the launch (0 = ok),
// or NO_INSTANCE for an S that is not compiled.
extern "C" int closest_sweep(const void* slab, const void* rays,
                             const void* order, const void* entry,
                             const void* n_cand, const void* block_order,
                             void* best_t, void* best_cid, void* best_slot,
                             int b, int s, int r_lanes, int c_pad, float t_min,
                             void* stream) {
  if (b <= 0) return 0;
  const ClosestArgs p = {(const float*)slab,  (const float*)rays,
                         (const int*)order,   (const float*)entry,
                         (const int*)n_cand,  (const int*)block_order,
                         (float*)best_t,      (int*)best_cid,
                         (int*)best_slot,     r_lanes,
                         c_pad,               t_min};
#define LAUNCH(S_) \
  if (s == S_) return closest_launch_s<S_>(p, b, (cudaStream_t)stream);
  FOR_SWEEP_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of closest_sweep's instance for (S, R) and the warps
// an SM holds of it.
extern "C" int closest_sweep_occupancy(int s, int r_lanes, int* regs,
                                       int* warps_per_sm) {
#define OCCUPANCY(S_) \
  if (s == S_) return closest_occupancy_s<S_>(r_lanes, regs, warps_per_sm);
  FOR_SWEEP_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

extern "C" int anyhit_sweep(const void* slab, const void* rays,
                            const void* order, const void* n_cand, void* occ,
                            int b, int s, int r_lanes, int c_pad, float t_min,
                            void* stream) {
  if (b <= 0) return 0;
#define LAUNCH(S_)                                                     \
  if (s == S_)                                                         \
    return anyhit_launch<S_>(slab, rays, order, n_cand, occ, b, r_lanes, \
                             c_pad, t_min, (cudaStream_t)stream);
  FOR_SWEEP_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of anyhit_sweep's S instance and the warps an SM
// holds of it.
extern "C" int anyhit_sweep_occupancy(int s, int* regs, int* warps_per_sm) {
#define OCCUPANCY(S_) \
  if (s == S_) return anyhit_occupancy<S_>(regs, warps_per_sm);
  FOR_SWEEP_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// ---- the generic instances: any S (mt.cuh CHUNK) ---------------------------
//
// For an S that no instance above is compiled for (any S >= 1, at run
// time). closest_sweep_generic: one warp group (P = 1), one ray a thread,
// ceil(R / 32) warps a block, the same walk and vote as the tuned kernel;
// each candidate is staged 32 triangles at a time by warp 0 (mt.cuh
// stage_chunk_warp, zeros past S) and tested by sweep_first<32>, chunks in
// slot order, so a hit replaces the best only with t < best and the first
// slot of the first candidate still wins a tie. anyhit_sweep_generic: the
// tuned kernel's per-warp walk, each candidate in chunks of 32 through
// anyhit_run<32>, leaving once each lane is occluded or dead.
__global__ void __launch_bounds__(1024, 1)
    closest_sweep_generic_kernel(const ClosestArgs p, int s) {
  __shared__ TriRec buf[CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int idx = threadIdx.x;  // this thread's lane of R
  const size_t blk = p.block_order[blockIdx.x];
  const int r_lanes = p.r_lanes;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float cap = -1.0f;
  if (idx < r_lanes) {
    const float* rp = p.rays + blk * RAY_ROWS * r_lanes + idx;
    ray = load_ray(rp, r_lanes);
    cap = rp[6 * r_lanes];
  }
  const float tmin = p.t_min;
  const bool voter = idx < r_lanes && !(cap < 0.0f);  // live
  const bool testing = __any_sync(FULL_MASK, cap >= tmin);
  float best_t = INFINITY;
  int best_k = I32_MAX, best_slot = 0;

  const int n_i = p.n_cand[blk];
  const int* my_order = p.order + blk * p.c_pad;
  const float* my_entry = p.entry + blk * p.c_pad;
  bool walking = true;
  for (int k0 = 0; walking && k0 < n_i; k0 += 32) {
    const bool listed = k0 + lane < n_i;
    const int my_cid = listed ? my_order[k0 + lane] : 0;
    const float my_e = listed ? my_entry[k0 + lane] : INFINITY;
    const int n_here = min(32, n_i - k0);
    for (int j = 0; j < n_here; ++j) {
      const float e = __shfl_sync(FULL_MASK, my_e, j);
      if (!__syncthreads_or(voter && e <= best_t)) {
        walking = false;
        break;
      }
      const float* cluster =
          p.slab + (size_t)__shfl_sync(FULL_MASK, my_cid, j) * SLAB_ROWS * s;
#pragma unroll 1
      for (int c0 = 0; c0 < s; c0 += CHUNK) {
        if (warp == 0) {
          stage_chunk_warp<SLAB_ROWS>(buf, cluster, s, c0, lane);
          cp_async_wait_all();
        }
        __syncthreads();
        if (testing) {
          int slot = -1;
          sweep_first<CHUNK>(buf, k0 + j, ray, tmin, cap, best_t, best_k,
                             slot);
          if (slot >= 0) best_slot = c0 + slot;
        }
        __syncthreads();  // every thread is done with the buffer
      }
    }
  }
  if (idx < r_lanes) {
    const size_t o = blk * r_lanes + idx;
    p.best_t[o] = best_t;
    p.best_cid[o] = best_k == I32_MAX ? -1 : my_order[best_k];
    p.best_slot[o] = best_k == I32_MAX ? 0 : best_slot;
  }
}

__global__ void __launch_bounds__(SWEEP_WARPS * 32, SWEEP_MIN_BLOCKS(1))
    anyhit_sweep_generic_kernel(const float* __restrict__ slab,
                                const float* __restrict__ rays,
                                const int* __restrict__ order,
                                const int* __restrict__ n_cand,
                                unsigned char* __restrict__ occ_out, int b,
                                int r_lanes, int c_pad, float t_min, int s) {
  __shared__ TriRec bufs[SWEEP_WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = (r_lanes + 31) >> 5;  // warps per ray block
  const int unit = blockIdx.x * SWEEP_WARPS + warp;
  if (unit >= b * wpb) return;  // whole warps leave: no block barrier
  const size_t blk = (size_t)(unit / wpb);
  const int off = (unit % wpb) * 32 + lane;  // this thread's lane of R
  TriRec* buf = bufs[warp];

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float t_cap = -1.0f;
  if (off < r_lanes) {
    const float* r = rays + blk * RAY_ROWS * r_lanes + off;
    ray = load_ray(r, r_lanes);
    t_cap = r[6 * r_lanes];
  }
  const bool dead = !(t_cap >= t_min);  // can pass no test
  bool occ = false;
  const int n_i = n_cand[blk];
  const int* my_order = order + blk * c_pad;
  for (int k0 = 0; k0 < n_i && !__all_sync(FULL_MASK, occ || dead);
       k0 += 32) {
    const int my_cid = k0 + lane < n_i ? my_order[k0 + lane] : 0;
    const int n_here = min(32, n_i - k0);
    for (int j = 0; j < n_here; ++j) {
      const float* cluster =
          slab + (size_t)__shfl_sync(FULL_MASK, my_cid, j) * SLAB_ROWS * s;
#pragma unroll 1
      for (int c0 = 0; c0 < s; c0 += CHUNK) {
        if (__all_sync(FULL_MASK, occ || dead)) break;
        stage_chunk_warp<SLAB_ROWS>(buf, cluster, s, c0, lane);
        cp_async_wait_all();
        __syncwarp();
        occ = anyhit_run<CHUNK>(buf, ray, t_min, t_cap, dead, occ);
        __syncwarp();  // every lane is done with the buffer
      }
    }
  }
  if (off < r_lanes) occ_out[blk * r_lanes + off] = occ ? 1 : 0;
}

// closest_sweep's and anyhit_sweep's generic instances, with their
// arguments, for any S >= 1.
extern "C" int closest_sweep_generic(const void* slab, const void* rays,
                                     const void* order, const void* entry,
                                     const void* n_cand,
                                     const void* block_order, void* best_t,
                                     void* best_cid, void* best_slot, int b,
                                     int s, int r_lanes, int c_pad,
                                     float t_min, void* stream) {
  if (b <= 0) return 0;
  if (s < 1 || r_lanes < 1 || r_lanes > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const ClosestArgs p = {(const float*)slab,  (const float*)rays,
                         (const int*)order,   (const float*)entry,
                         (const int*)n_cand,  (const int*)block_order,
                         (float*)best_t,      (int*)best_cid,
                         (int*)best_slot,     r_lanes,
                         c_pad,               t_min};
  closest_sweep_generic_kernel<<<b, 32 * ((r_lanes + 31) / 32), 0,
                                 (cudaStream_t)stream>>>(p, s);
  return (int)cudaGetLastError();
}

extern "C" int anyhit_sweep_generic(const void* slab, const void* rays,
                                    const void* order, const void* n_cand,
                                    void* occ, int b, int s, int r_lanes,
                                    int c_pad, float t_min, void* stream) {
  if (b <= 0) return 0;
  if (s < 1 || r_lanes < 1) return (int)cudaErrorInvalidValue;
  const int units = b * ((r_lanes + 31) / 32);
  const int blocks = (units + SWEEP_WARPS - 1) / SWEEP_WARPS;
  anyhit_sweep_generic_kernel<<<blocks, SWEEP_WARPS * 32, 0,
                                (cudaStream_t)stream>>>(
      (const float*)slab, (const float*)rays, (const int*)order,
      (const int*)n_cand, (unsigned char*)occ, b, r_lanes, c_pad, t_min, s);
  return (int)cudaGetLastError();
}
