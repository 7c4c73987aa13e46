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
// closest_sweep. One thread block per ray block, one thread per lane. Per
// candidate the block stages the cluster's 9 x S rows in shared memory
// (4.6 KB at S = 128) and each thread walks the S triangles, reading the
// same shared word at the same time (a broadcast). The TPU kernel's double-
// buffered DMA with its semaphore drain has no counterpart: many blocks are
// resident on an SM, and one block's staging overlaps its neighbours'
// arithmetic. The loop condition is a block-wide vote that every thread
// reaches (no thread returns early): go on while k < n_cand and entry[k] <=
// the largest best_t of the live lanes (dead lanes count as -inf), i.e.
// while some live lane still has entry[k] <= best_t (__syncthreads_or).
// Ties: a test replaces the best only with t < best, so the first slot of
// the first candidate at the minimum wins (the TPU kernel's argmin and
// `closer` rule), which may differ from the oracle's min-tri rule on an
// exact tie.
//
// anyhit_sweep (the inner loop is mt.cuh's anyhit_run). The unit of work is
// a warp of 32 lanes of a ray block (R / 32 of them, rounded up; lanes past
// R are dead), one ray a thread, four warps a thread block that share
// nothing (only __syncwarp). Each warp walks the block's own list front to
// back, reading 32 ids at a time (one a lane, handed round by __shfl), and
// stages each cluster for itself, transposed, with cp.async (nine rows,
// 4.5 KB at S = 128). It stops once each of its lanes is occluded or dead
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
// number of visits depends on the data. Build with --fmad=false (see
// mt.cuh).

#include "mt.cuh"

#define SLAB_ROWS 9

__global__ void closest_sweep_kernel(const float* __restrict__ slab,
                                     const float* __restrict__ rays,
                                     const int* __restrict__ order,
                                     const float* __restrict__ entry,
                                     const int* __restrict__ n_cand,
                                     float* __restrict__ best_t_out,
                                     int* __restrict__ best_cid_out,
                                     int* __restrict__ best_slot_out,
                                     int s, int r_lanes, int c_pad,
                                     float t_min) {
  extern __shared__ float tri[];  // [SLAB_ROWS, s]
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const bool in_range = lane < r_lanes;
  const int n_i = n_cand[blk];
  const int* my_order = order + (size_t)blk * c_pad;
  const float* my_entry = entry + (size_t)blk * c_pad;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float t_cap = -1.0f;
  if (in_range) {
    const float* r = rays + (size_t)blk * RAY_ROWS * r_lanes + lane;
    ray = load_ray(r, r_lanes);
    t_cap = r[6 * r_lanes];
  }
  const bool live = in_range && !(t_cap < 0.0f);

  float best_t = INFINITY;
  int best_cid = -1;
  int best_slot = 0;
  for (int k = 0; k < n_i; ++k) {
    // Front-to-back stop; also the barrier between the previous
    // candidate's tests and this one's staging.
    if (!__syncthreads_or(live && my_entry[k] <= best_t)) break;
    const int cid = my_order[k];
    stage_rows(tri, slab + (size_t)cid * SLAB_ROWS * s, SLAB_ROWS * s);
    __syncthreads();
    if (in_range) {
      for (int j = 0; j < s; ++j) {
        float t;
        if (mt_test(ray, tri, s, j, t_min, t_cap, &t) && t < best_t) {
          best_t = t;
          best_cid = cid;
          best_slot = j;
        }
      }
    }
  }
  if (in_range) {
    const size_t o = (size_t)blk * r_lanes + lane;
    best_t_out[o] = best_t;
    best_cid_out[o] = best_cid;
    best_slot_out[o] = best_slot;
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
#define FOR_ANYHIT_INSTANCES(CALL) CALL(64) CALL(128) CALL(256)

static int block_threads(int lanes) { return ((lanes + 31) / 32) * 32; }

// Both launch on `stream` and return the cudaError_t of the launch (0 = ok);
// anyhit_sweep returns NO_INSTANCE for an S that is not compiled.
extern "C" int closest_sweep(const void* slab, const void* rays,
                             const void* order, const void* entry,
                             const void* n_cand, void* best_t, void* best_cid,
                             void* best_slot, int b, int s, int r_lanes,
                             int c_pad, float t_min, void* stream) {
  if (b <= 0) return 0;
  const size_t smem = (size_t)SLAB_ROWS * s * sizeof(float);
  closest_sweep_kernel<<<b, block_threads(r_lanes), smem,
                         (cudaStream_t)stream>>>(
      (const float*)slab, (const float*)rays, (const int*)order,
      (const float*)entry, (const int*)n_cand, (float*)best_t, (int*)best_cid,
      (int*)best_slot, s, r_lanes, c_pad, t_min);
  return (int)cudaGetLastError();
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
  FOR_ANYHIT_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of anyhit_sweep's S instance and the warps an SM
// holds of it.
extern "C" int anyhit_sweep_occupancy(int s, int* regs, int* warps_per_sm) {
#define OCCUPANCY(S_) \
  if (s == S_) return anyhit_occupancy<S_>(regs, warps_per_sm);
  FOR_ANYHIT_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}
