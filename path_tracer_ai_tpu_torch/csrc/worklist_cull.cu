// The worklist's cull for Hopper (sm_90a): worklist_cull.
//
// Replaces no Pallas kernel: it is the XLA-fused CULL + EXTRACT of
// path_tracer_ai_tpu/accel/worklist.py `_build_worklist` (worklist.py:
// 169-266, `one_chunk_flat` and `one_chunk_2level`), the conservative cull
// of every block of B rays against the cluster boxes and the block's first
// k_eff candidate ids in ascending order. JAX runs it as one executable
// (a lax.map over row chunks); the port's plain version
// (accel/cuda_cull.py worklist_cull_plain) as some hundred eager ops over
// [rows, C] or [rows, Cs + scap * ss] temporaries a chunk.
//
// Layouts (accel/cuda_cull.py worklist_cull):
//   o_blk, d_blk [nb, B, 3] f32; tm_blk [nb, B] f32 (t_max; negative or
//   NaN: a dead lane); bmin, bmax [C, 3] f32 (levels 1); sbmin, sbmax
//   [Cs, 3] and cbmin, cbmax [Cs, ss, 3] f32 (levels 2; the padding
//   children of a partly filled last super hold inverted boxes).
//   order [nb, width] i32, width >= k_eff: the first k_eff candidate ids
//   ascending, C - 1 past the count (all C - 1 where the block
//   overflows), zeros in the pad columns [k_eff, width) (order_g's);
//   n_cand [nb] i32, 0 where the block overflows; over [nb] u8.
//
// Per ray block, what JAX computes:
//   1. the bounds of its live lanes and tmax_ub (csrc/interval.cuh,
//      shared with packet_cull.cu). A block whose tmax_ub is not >= 0
//      (all dead, or a NaN t_max) has no candidate.
//   2. levels 1: interval.cuh's slab_candidate against every cluster box;
//      over = n_cand > cap.
//      levels 2: the same test against the super boxes; ns of them pass,
//      over_s = ns > scap; the children of the passing supers (all ns of
//      them where not over_s), in ascending super order, are tested in
//      turn; over = over_s | n_cand > cap. A padding child passes the
//      test whatever the ray (its inverted box gives (-huge, +huge)) and
//      counts, as in the reference; its id (>= C) is written as C - 1.
//   3. order: the candidates' ids in ascending order (ascending children
//      of ascending supers are ascending ids), the first k_eff of them.
//
// Design: one warp a ray block, WL_WARPS warps a thread block sharing
// nothing. The lanes reduce the block's bounds with shuffles. Lanes then
// stride the boxes 32 at a time; a ballot and a popc prefix place each
// chunk's passing ids in ascending order. At levels 2 the passing supers
// of a chunk of 32 go to the warp's list in shared memory, and the warp
// sweeps their children flat, (super, child) pairs 32 at a time, before
// the next chunk of supers. Once a count passes its cap (n_cand > cap, or
// ns > scap) the block's outputs are fixed (overflow), and the warp stops.
//
// What bounds it: the bytes on the worklist's waves (the rays in, 28 B a
// lane; order out, 4 B a slot of width; n_cand and over) against the
// operations (chip_smoke.py WCULL_AXIS_OPS, WCULL_PAIR_OPS: 14 f32
// operations a (block, box) pair and axis whose direction interval does
// not span 0, 3 compares a pair), counted over the boxes this run's blocks
// test up to their stop. The divisions' latency is what the design spends
// beyond the bound.

#include "interval.cuh"

#define WL_WARPS 8

struct WlArgs {
  const float* o_blk;
  const float* d_blk;
  const float* tm_blk;
  const float* bmin;   // [C, 3] (levels 1) or [Cs, 3] supers (levels 2)
  const float* bmax;
  const float* cbmin;  // [Cs, ss, 3] children (levels 2)
  const float* cbmax;
  int* order;
  int* n_cand;
  unsigned char* over;
  int nb, b, c, n_boxes, ss, levels, cap, scap, k_eff, width;
};

// Appends the passing ids of one chunk (hit, id per lane) to the row at
// *count, in lane order; returns whether the count passed cap.
__device__ __forceinline__ bool append(const WlArgs& a, int* ord, bool hit,
                                       int id, int lane, int* count) {
  const unsigned m = __ballot_sync(FULL_MASK, hit);
  const int pos = *count + __popc(m & ((1u << lane) - 1u));
  if (hit && pos < a.k_eff) ord[pos] = id < a.c ? id : a.c - 1;
  *count += __popc(m);
  return *count > a.cap;
}

__global__ void __launch_bounds__(WL_WARPS * 32)
    worklist_cull_kernel(const WlArgs a) {
  __shared__ int supers[WL_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x * WL_WARPS + warp;
  if (blk >= a.nb) return;  // whole warps leave; there is no block barrier

  float v[BOUNDS_N];
  unsigned nan_bits;
  bounds_init(v, &nan_bits);
  for (int l = lane; l < a.b; l += 32) {
    const size_t i = (size_t)blk * a.b + l;
    bounds_add_lane(v, &nan_bits, a.o_blk + 3 * i, a.d_blk + 3 * i,
                    a.tm_blk[i]);
  }
  bounds_warp_reduce(v, &nan_bits);
  bounds_put_nan(v, nan_bits);
  const SlabBlock sb = slab_block(v);

  int* ord = a.order + (size_t)blk * a.width;
  int count = 0;
  bool ov = false;
  if (sb.tmax_ub >= 0.0f) {  // false for NaN: no candidate
    float lb;
    if (a.levels == 1) {
      for (int c0 = 0; c0 < a.n_boxes && !ov; c0 += 32) {
        const int k = c0 + lane;
        const bool hit = k < a.n_boxes &&
                         slab_candidate(sb, a.bmin + 3 * k, a.bmax + 3 * k,
                                        &lb);
        ov = append(a, ord, hit, k, lane, &count);
      }
    } else {
      int ns = 0;
      for (int s0 = 0; s0 < a.n_boxes && !ov; s0 += 32) {
        const int sid = s0 + lane;
        const bool hit = sid < a.n_boxes &&
                         slab_candidate(sb, a.bmin + 3 * sid,
                                        a.bmax + 3 * sid, &lb);
        const unsigned m = __ballot_sync(FULL_MASK, hit);
        const int n_new = __popc(m);
        if (ns + n_new > a.scap) {  // over_s: the supers past scap unseen
          ov = true;
          break;
        }
        ns += n_new;
        if (hit) supers[warp][__popc(m & ((1u << lane) - 1u))] = sid;
        __syncwarp();
        const int pairs = n_new * a.ss;
        for (int p0 = 0; p0 < pairs && !ov; p0 += 32) {
          const int p = p0 + lane;
          bool h = false;
          int child = 0;
          if (p < pairs) {
            const int si = p / a.ss;
            child = supers[warp][si] * a.ss + (p - si * a.ss);
            h = slab_candidate(sb, a.cbmin + 3 * (size_t)child,
                               a.cbmax + 3 * (size_t)child, &lb);
          }
          ov = append(a, ord, h, child, lane, &count);
        }
        __syncwarp();  // every lane is done reading the list
      }
    }
  }
  const int filled = ov ? 0 : (count < a.k_eff ? count : a.k_eff);
  for (int j = filled + lane; j < a.k_eff; j += 32) ord[j] = a.c - 1;
  for (int j = a.k_eff + lane; j < a.width; j += 32) ord[j] = 0;
  if (lane == 0) {
    a.n_cand[blk] = ov ? 0 : count;
    a.over[blk] = ov ? 1 : 0;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// levels 1: bmin / bmax are the C cluster boxes (n_boxes = C), cbmin /
// cbmax unused; levels 2: bmin / bmax the n_boxes = Cs super boxes, cbmin
// / cbmax the [Cs, ss, 3] children. k_eff <= width.
extern "C" int worklist_cull(const void* o_blk, const void* d_blk,
                             const void* tm_blk, const void* bmin,
                             const void* bmax, const void* cbmin,
                             const void* cbmax, int nb, int b, int c,
                             int n_boxes, int ss, int levels, int cap,
                             int scap, int k_eff, int width, void* order,
                             void* n_cand, void* over, void* stream) {
  if (nb <= 0) return 0;
  if (b < 1 || c < 1 || n_boxes < 1 || cap < 0 || k_eff < 0 ||
      k_eff > width || (levels != 1 && levels != 2) ||
      (levels == 2 && (ss < 1 || scap < 0 || cbmin == nullptr ||
                       cbmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  WlArgs a = {(const float*)o_blk, (const float*)d_blk,
              (const float*)tm_blk, (const float*)bmin, (const float*)bmax,
              (const float*)cbmin, (const float*)cbmax, (int*)order,
              (int*)n_cand, (unsigned char*)over, nb, b, c, n_boxes, ss,
              levels, cap, scap, k_eff, width};
  const int grid = (nb + WL_WARPS - 1) / WL_WARPS;
  worklist_cull_kernel<<<grid, WL_WARPS * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers per thread and resident warps per SM.
extern "C" int worklist_cull_occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, worklist_cull_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, worklist_cull_kernel, WL_WARPS * 32, 0);
  *warps_per_sm = blocks * WL_WARPS;
  return (int)err;
}
