// ctiles' culls for Hopper (sm_90a): block_cull, flat and 2-level.
//
// Replaces no Pallas kernel: it is the XLA-fused body of
// path_tracer_ai_tpu/accel/ctiles.py `_ray_masks` and `_extract_order_flat`
// (ctiles.py:81-191), the per-ray inclusive slab test of every ray of a
// block against every cluster box, OR'd per block, and the block's first
// `cap` candidate ids in ascending order; and, at levels 2, of
// `_block_candidates_2level` (ctiles.py:194-343): the block's supercluster
// shortlist, then its rays' tests against the shortlist's children. JAX
// runs each inside a `fori_loop` bounded by the live-block count (a traced
// value); here the count is read from device memory by the kernel, so the
// host reads nothing.
//
// Layouts (accel/cuda_ctiles.py block_cull):
//   o_blk, d_blk [nb, b, 3] f32; tm_blk [nb, b] f32 (negative: dead);
//   bmin, bmax [C, 3] f32; live_blocks: one i32 in device memory (null:
//   every block).
//   order [nb, kx] i32, kx = min(cap, C): ascending candidate ids, C - 1
//   past n_cand; n_cand [nb] i32, 0 where the block overflows (more than
//   cap candidates; its order row is all C - 1); over [nb] u8.
//   Blocks at or past live_blocks write the empty set (their rays are dead:
//   waves are sorted dead-last, so their sets are empty anyway).
//
// Design: one warp a block, CULL_WARPS warps a thread block sharing nothing
// but their rays. The warp stages its block's b rays (origin, 1 / d, the
// window [t_min, t_max or -inf for a dead ray]) in shared memory; lanes
// stride the cluster ids, 32 at a time, each lane testing its box against
// the block's rays until one passes; a ballot and popc place the passing
// ids in ascending order.
//
// Exactness: the test is kslots._ray_slab's, op for op: inv = 1 / d (the
// IEEE division: no --use_fast_math), t0 = (bmin - o) inv, t1 = (bmax - o)
// inv; torch.minimum / maximum propagate a NaN (0 * inf, an origin on a
// slab plane of an axis-parallel ray), which the plain version then
// replaces by -inf (near) and +inf (far), so here a NaN in t0 or t1 gives
// that axis (-inf, +inf) explicitly (fminf / fmaxf would drop the NaN and
// keep the other bound); hi >= lo inclusive, so flat boxes stay in. Only
// the boolean leaves the test, and it does not depend on which zero a
// minimum returns.
//
// Levels 2 (block_cull2_kernel), per block, with scap = min(super_cap,
// Cs) and kx = min(cap, scap * ss, C):
//   1. Supers: each super box against the block's rays in kslots' rule
//      (slab_hit; ray_slab.cuh) until one passes; ns pass. ns > scap
//      overflows the block (the scan stops once that is known); else the
//      ns ids ascending go to the warp's list in shared memory.
//   2. Children: the listed supers' ss children each, in (super, child)
//      order, which is ascending cluster id, against the block's rays in
//      perray's comparison-select rule (perray_slab; the window [t_min,
//      t_max or -inf for a dead ray]), until one passes: ctiles.py's
//      sign-select where-form, so the inverted padding children of a
//      partly filled last super ("phantoms") fail. A passing child counts,
//      and its id clamped to C - 1 is listed.
//   3. More than kx children overflow the block (the scan stops once that
//      is known). order [nb, kx], n_cand and over as at levels 1.
//   Rows at or past live_blocks write the empty set, as at levels 1 (the
//   plain version, accel/cuda_ctiles.py block_cull_plain, does the same;
//   JAX's leaves zeros past its last computed chunk).
//
// What bounds it: operations, 31 f32 operations a ray/box test (slab_hit:
// an axis 2 subtractions, 2 products, 2 NaN compares, a min and a max; 3
// max, 3 min and the final compare; the NaN selects not counted), tests
// counted up to the first ray of the block that passes; the bytes (the
// rays and the tables, ~1.4 MB for a 2^20 wave at cap 48) are far below.

#include <cuda_runtime.h>
#include <math.h>

#include "ray_slab.cuh"

#define CULL_WARPS 8
#define CULL_RAY_WORDS 8  // a RayIn

// One axis of the slab test: (near, far) with a NaN bound -> (-inf, +inf).
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o,
                                          float inv, float* near,
                                          float* far) {
  const float t0 = (bmin - o) * inv;
  const float t1 = (bmax - o) * inv;
  const bool nan = t0 != t0 || t1 != t1;
  *near = nan ? -INFINITY : fminf(t0, t1);
  *far = nan ? INFINITY : fmaxf(t0, t1);
}

__device__ __forceinline__ bool slab_hit(const RayIn& r, const float* lo3,
                                         const float* hi3) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis(lo3[0], hi3[0], r.o[0], r.inv[0], &nx, &fx);
  slab_axis(lo3[1], hi3[1], r.o[1], r.inv[1], &ny, &fy);
  slab_axis(lo3[2], hi3[2], r.o[2], r.inv[2], &nz, &fz);
  const float lo = fmaxf(fmaxf(fmaxf(nx, ny), nz), r.lo0);
  const float hi = fminf(fminf(fminf(fx, fy), fz), r.hi0);
  return hi >= lo;
}

// Stages block blk's b rays in the warp's shared buffer: origin, 1 / d
// (IEEE), the window [t_min, t_max or -inf for a dead ray].
__device__ __forceinline__ void stage_rays(RayIn* rays,
                                           const float* __restrict__ o_blk,
                                           const float* __restrict__ d_blk,
                                           const float* __restrict__ tm_blk,
                                           float t_min, int blk, int b,
                                           int lane) {
  for (int r = lane; r < b; r += 32) {
    const size_t i = (size_t)blk * b + r;
    const float tm = tm_blk[i];
    RayIn& x = rays[r];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x.o[a] = o_blk[3 * i + a];
      x.inv[a] = 1.0f / d_blk[3 * i + a];
    }
    x.lo0 = t_min;
    x.hi0 = tm >= 0.0f ? tm : -INFINITY;
  }
  __syncwarp();
}

// The empty set of a block at or past the live-block count.
__device__ __forceinline__ void empty_block(int* ord, int kx, int c, int blk,
                                            int* n_cand, unsigned char* over,
                                            int lane) {
  for (int j = lane; j < kx; j += 32) ord[j] = c - 1;
  if (lane == 0) {
    n_cand[blk] = 0;
    over[blk] = 0;
  }
}

__global__ void __launch_bounds__(CULL_WARPS * 32)
    block_cull_kernel(const float* __restrict__ o_blk,
                      const float* __restrict__ d_blk,
                      const float* __restrict__ tm_blk,
                      const float* __restrict__ bmin,
                      const float* __restrict__ bmax, float t_min,
                      const int* __restrict__ live_blocks, int nb, int b,
                      int c, int cap, int kx, int* __restrict__ order,
                      int* __restrict__ n_cand,
                      unsigned char* __restrict__ over) {
  extern __shared__ __align__(16) float cull_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x * CULL_WARPS + warp;
  if (blk >= nb) return;  // whole warps leave; there is no block barrier
  int* ord = order + (size_t)blk * kx;
  const int live = live_blocks ? *live_blocks : nb;
  if (blk >= live) {
    empty_block(ord, kx, c, blk, n_cand, over, lane);
    return;
  }
  RayIn* rays = reinterpret_cast<RayIn*>(cull_smem) + (size_t)warp * b;
  stage_rays(rays, o_blk, d_blk, tm_blk, t_min, blk, b, lane);
  int count = 0;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int cid = c0 + lane;
    bool hit = false;
    if (cid < c) {
      const float lo3[3] = {__ldg(bmin + 3 * cid), __ldg(bmin + 3 * cid + 1),
                            __ldg(bmin + 3 * cid + 2)};
      const float hi3[3] = {__ldg(bmax + 3 * cid), __ldg(bmax + 3 * cid + 1),
                            __ldg(bmax + 3 * cid + 2)};
      for (int r = 0; r < b && !hit; ++r) hit = slab_hit(rays[r], lo3, hi3);
    }
    const unsigned m = __ballot_sync(FULL_MASK, hit);
    const int pos = count + __popc(m & ((1u << lane) - 1u));
    if (hit && pos < kx) ord[pos] = cid;
    count += __popc(m);
  }
  const bool ov = count > cap;
  const int n = ov ? 0 : count;  // count <= kx where it does not overflow
  for (int j = n + lane; j < kx; j += 32) ord[j] = c - 1;
  if (lane == 0) {
    n_cand[blk] = n;
    over[blk] = ov ? 1 : 0;
  }
}

struct Cull2Args {
  const float* o_blk;
  const float* d_blk;
  const float* tm_blk;
  const float* sbmin;  // [Cs, 3]
  const float* sbmax;
  const float* cbmin;  // [Cs, ss, 3]
  const float* cbmax;
  const int* live_blocks;
  int* order;
  int* n_cand;
  unsigned char* over;
  float t_min;
  int nb, b, c, cs, ss, scap, kx;
};

__global__ void __launch_bounds__(CULL_WARPS * 32)
    block_cull2_kernel(const Cull2Args a) {
  extern __shared__ __align__(16) float cull_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x * CULL_WARPS + warp;
  if (blk >= a.nb) return;  // whole warps leave; there is no block barrier
  int* ord = a.order + (size_t)blk * a.kx;
  const int live = a.live_blocks ? *a.live_blocks : a.nb;
  if (blk >= live) {
    empty_block(ord, a.kx, a.c, blk, a.n_cand, a.over, lane);
    return;
  }
  RayIn* rays = reinterpret_cast<RayIn*>(cull_smem) + (size_t)warp * a.b;
  int* sup = reinterpret_cast<int*>(reinterpret_cast<RayIn*>(cull_smem) +
                                    (size_t)CULL_WARPS * a.b) +
             (size_t)warp * a.scap;
  stage_rays(rays, a.o_blk, a.d_blk, a.tm_blk, a.t_min, blk, a.b, lane);
  // 1. the block's supers, ascending, until their count passes scap
  int ns = 0;
  for (int s0 = 0; s0 < a.cs && ns <= a.scap; s0 += 32) {
    const int sid = s0 + lane;
    bool hit = false;
    if (sid < a.cs) {
      float lo3[3], hi3[3];
      load_box(a.sbmin + 3 * (size_t)sid, lo3);
      load_box(a.sbmax + 3 * (size_t)sid, hi3);
      for (int r = 0; r < a.b && !hit; ++r) hit = slab_hit(rays[r], lo3, hi3);
    }
    ns += put_ids(sup, a.scap, hit, sid, lane, ns);
  }
  __syncwarp();  // the list is written
  // 2. the listed supers' children, ascending, until their count passes kx
  const int pairs = ns > a.scap ? 0 : ns * a.ss;
  int count = 0;
  for (int p0 = 0; p0 < pairs && count <= a.kx; p0 += 32) {
    const int p = p0 + lane;
    bool hit = false;
    int child = 0;
    if (p < pairs) {
      const int si = p / a.ss;
      child = sup[si] * a.ss + (p - si * a.ss);
      float lo3[3], hi3[3];
      load_box(a.cbmin + 3 * (size_t)child, lo3);
      load_box(a.cbmax + 3 * (size_t)child, hi3);
      for (int r = 0; r < a.b && !hit; ++r)
        hit = perray_slab(rays[r], lo3, hi3);
    }
    count += put_ids(ord, a.kx, hit, min(child, a.c - 1), lane, count);
  }
  const bool ov = ns > a.scap || count > a.kx;
  const int n = ov ? 0 : count;
  __syncwarp();  // the ids are written before the fill may replace them
  for (int j = n + lane; j < a.kx; j += 32) ord[j] = a.c - 1;
  if (lane == 0) {
    a.n_cand[blk] = n;
    a.over[blk] = ov ? 1 : 0;
  }
}

static size_t cull2_smem_bytes(int b, int scap) {
  return (size_t)CULL_WARPS * (b * CULL_RAY_WORDS * sizeof(float) +
                               scap * sizeof(int));
}

static size_t cull_smem_bytes(int b) {
  return (size_t)CULL_WARPS * b * CULL_RAY_WORDS * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// kx must be min(cap, c).
extern "C" int block_cull(const void* o_blk, const void* d_blk,
                          const void* tm_blk, const void* bmin,
                          const void* bmax, float t_min,
                          const void* live_blocks, int nb, int b, int c,
                          int cap, int kx, void* order, void* n_cand,
                          void* over, void* stream) {
  if (nb <= 0) return 0;
  if (b < 1 || c < 1 || cap < 1 || kx != (cap < c ? cap : c)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = cull_smem_bytes(b);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (nb + CULL_WARPS - 1) / CULL_WARPS;
  block_cull_kernel<<<blocks, CULL_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)o_blk, (const float*)d_blk, (const float*)tm_blk,
      (const float*)bmin, (const float*)bmax, t_min, (const int*)live_blocks,
      nb, b, c, cap, kx, (int*)order, (int*)n_cand, (unsigned char*)over);
  return (int)cudaGetLastError();
}

// The 2-level cull: supers sbmin / sbmax [cs, 3], children cbmin / cbmax
// [cs, ss, 3] (cs * ss >= c); scap = min(super_cap, cs) >= 1 and kx =
// min(cap, scap * ss, c). Launches on `stream`; returns the cudaError_t of
// the launch (0 = ok).
extern "C" int block_cull_2level(const void* o_blk, const void* d_blk,
                                 const void* tm_blk, const void* sbmin,
                                 const void* sbmax, const void* cbmin,
                                 const void* cbmax, float t_min,
                                 const void* live_blocks, int nb, int b,
                                 int c, int cs, int ss, int scap, int kx,
                                 void* order, void* n_cand, void* over,
                                 void* stream) {
  if (nb <= 0) return 0;
  if (b < 1 || c < 1 || cs < 1 || ss < 1 || scap < 1 || scap > cs ||
      (long long)cs * ss < c || kx < 1 || kx > c || kx > scap * ss)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cull2_smem_bytes(b, scap);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const Cull2Args a = {(const float*)o_blk, (const float*)d_blk,
                       (const float*)tm_blk, (const float*)sbmin,
                       (const float*)sbmax, (const float*)cbmin,
                       (const float*)cbmax, (const int*)live_blocks,
                       (int*)order, (int*)n_cand, (unsigned char*)over,
                       t_min, nb, b, c, cs, ss, scap, kx};
  const int blocks = (nb + CULL_WARPS - 1) / CULL_WARPS;
  block_cull2_kernel<<<blocks, CULL_WARPS * 32, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

// Registers per thread and resident warps per SM of the 2-level cull at b
// rays a block and a list of scap supers a warp.
extern "C" int block_cull2_occupancy(int b, int scap, int* regs,
                                     int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, block_cull2_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_cull2_kernel, CULL_WARPS * 32, cull2_smem_bytes(b, scap));
  *warps_per_sm = blocks * CULL_WARPS;
  return (int)err;
}

// Registers per thread and resident warps per SM at b rays a block.
extern "C" int block_cull_occupancy(int b, int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, block_cull_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_cull_kernel, CULL_WARPS * 32, cull_smem_bytes(b));
  *warps_per_sm = blocks * CULL_WARPS;
  return (int)err;
}
