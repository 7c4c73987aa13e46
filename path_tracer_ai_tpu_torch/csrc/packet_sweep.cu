// Per-block candidate walks of the `pallas` backend for Hopper (sm_90a).
//
// Replaces the TPU kernels of path_tracer_ai_tpu/accel/pallas_sweep.py:
// `closest_sweep_pallas` (`_closest_kernel`) and `anyhit_sweep_pallas`
// (`_anyhit_kernel`). Every block of R rays walks ITS OWN list of candidate
// clusters, front to back, inside the kernel, and stops as soon as the
// whole block is done, so one launch serves a whole wave and the host reads
// nothing back.
//
// Layouts (see accel/cuda_sweep.py):
//   slab   [C, 9, S] f32: v0.xyz, e1.xyz, e2.xyz rows of each cluster.
//   rays   [B, 8, R] f32: rows ox oy oz dx dy dz t_cap (row 7 unused);
//          t_cap < 0 marks a dead lane.
//   order  [B, C_pad] i32 candidate cluster ids by ascending entry bound.
//   entry  [B, C_pad] f32 those bounds (closest only).
//   n_cand [B] i32 candidates per block.
//   closest: best_t [B, R] f32 (inf = miss), best_cid [B, R] i32 (-1 =
//            none), best_slot [B, R] i32; any-hit: occ [B, R] u8 0/1.
//
// Design. One thread block per ray block, one thread per lane. Per
// candidate the block stages the cluster's 9 x S rows in shared memory
// (4.6 KB at S = 128) and each thread walks the S triangles, reading the
// same shared word at the same time (a broadcast). The TPU kernel's double-
// buffered DMA with its semaphore drain has no counterpart: many blocks are
// resident on an SM, and one block's staging overlaps its neighbours'
// arithmetic. The loop conditions are block-wide votes that every thread
// reaches (no thread returns early):
//   closest: go on while k < n_cand and entry[k] <= the largest best_t of
//            the live lanes (dead lanes count as -inf), i.e. while some
//            live lane still has entry[k] <= best_t (__syncthreads_or);
//   any-hit: go on while k < n_cand and some lane is not yet occluded
//            (!__syncthreads_and(occ)); as in the TPU kernel a dead lane is
//            never occluded, so a block that holds one walks its whole list.
// Ties: a test replaces the best only with t < best, so the first slot of
// the first candidate at the minimum wins (the TPU kernel's argmin and
// `closer` rule), which may differ from the oracle's min-tri rule on an
// exact tie. An occluded lane skips its remaining tests (same result).
//
// What bounds it. A visit of one cluster by one block is R*S tests of ~46
// f32 operations against 36*S bytes of triangle rows, mostly from L2, plus
// 8 bytes of order/entry: arithmetic bound, as the tile sweep; the number
// of visits depends on the data. Build with --fmad=false (see mt.cuh).

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

__global__ void anyhit_sweep_kernel(const float* __restrict__ slab,
                                    const float* __restrict__ rays,
                                    const int* __restrict__ order,
                                    const int* __restrict__ n_cand,
                                    unsigned char* __restrict__ occ_out,
                                    int s, int r_lanes, int c_pad,
                                    float t_min) {
  extern __shared__ float tri[];  // [SLAB_ROWS, s]
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const bool in_range = lane < r_lanes;
  const int n_i = n_cand[blk];
  const int* my_order = order + (size_t)blk * c_pad;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float t_cap = -1.0f;
  if (in_range) {
    const float* r = rays + (size_t)blk * RAY_ROWS * r_lanes + lane;
    ray = load_ray(r, r_lanes);
    t_cap = r[6 * r_lanes];
  }

  bool occ = false;
  for (int k = 0; k < n_i; ++k) {
    // Threads past R vote "occluded" so that they never hold the block.
    if (__syncthreads_and(occ || !in_range)) break;
    stage_rows(tri, slab + (size_t)my_order[k] * SLAB_ROWS * s, SLAB_ROWS * s);
    __syncthreads();
    if (in_range && !occ) {
      for (int j = 0; j < s; ++j) {
        float t;
        if (mt_test(ray, tri, s, j, t_min, t_cap, &t)) {
          occ = true;
          break;
        }
      }
    }
  }
  if (in_range) occ_out[(size_t)blk * r_lanes + lane] = occ ? 1 : 0;
}

static int block_threads(int lanes) { return ((lanes + 31) / 32) * 32; }

// Both launch on `stream` and return the cudaError_t of the launch (0 = ok).
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
  const size_t smem = (size_t)SLAB_ROWS * s * sizeof(float);
  anyhit_sweep_kernel<<<b, block_threads(r_lanes), smem,
                        (cudaStream_t)stream>>>(
      (const float*)slab, (const float*)rays, (const int*)order,
      (const int*)n_cand, (unsigned char*)occ, s, r_lanes, c_pad, t_min);
  return (int)cudaGetLastError();
}
