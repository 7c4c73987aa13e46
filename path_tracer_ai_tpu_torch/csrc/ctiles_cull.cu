// ctiles' flat cull for Hopper (sm_90a): block_cull.
//
// Replaces no Pallas kernel: it is the XLA-fused body of
// path_tracer_ai_tpu/accel/ctiles.py `_ray_masks` and `_extract_order_flat`
// (ctiles.py:81-191), the per-ray inclusive slab test of every ray of a
// block against every cluster box, OR'd per block, and the block's first
// `cap` candidate ids in ascending order. JAX runs both inside a
// `fori_loop` bounded by the live-block count (a traced value); here the
// count is read from device memory by the kernel, so the host reads
// nothing.
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
// What bounds it: operations, 31 f32 operations a ray/box test (slab_hit:
// an axis 2 subtractions, 2 products, 2 NaN compares, a min and a max; 3
// max, 3 min and the final compare; the NaN selects not counted), tests
// counted up to the first ray of the block that passes; the bytes (the
// rays and the tables, ~1.4 MB for a 2^20 wave at cap 48) are far below.

#include <cuda_runtime.h>
#include <math.h>

#define CULL_WARPS 8
#define FULL_MASK 0xffffffffu
#define CULL_RAY_WORDS 8

struct CullRay {
  float ox, oy, oz, ix, iy, iz, lo, hi;
};

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

__device__ __forceinline__ bool slab_hit(const CullRay& r, const float* lo3,
                                         const float* hi3) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis(lo3[0], hi3[0], r.ox, r.ix, &nx, &fx);
  slab_axis(lo3[1], hi3[1], r.oy, r.iy, &ny, &fy);
  slab_axis(lo3[2], hi3[2], r.oz, r.iz, &nz, &fz);
  const float lo = fmaxf(fmaxf(fmaxf(nx, ny), nz), r.lo);
  const float hi = fminf(fminf(fminf(fx, fy), fz), r.hi);
  return hi >= lo;
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
    for (int j = lane; j < kx; j += 32) ord[j] = c - 1;
    if (lane == 0) {
      n_cand[blk] = 0;
      over[blk] = 0;
    }
    return;
  }
  CullRay* rays = reinterpret_cast<CullRay*>(cull_smem) + (size_t)warp * b;
  for (int r = lane; r < b; r += 32) {
    const size_t i = (size_t)blk * b + r;
    const float tm = tm_blk[i];
    rays[r] = CullRay{o_blk[3 * i],        o_blk[3 * i + 1],
                      o_blk[3 * i + 2],    1.0f / d_blk[3 * i],
                      1.0f / d_blk[3 * i + 1], 1.0f / d_blk[3 * i + 2],
                      t_min,               tm >= 0.0f ? tm : -INFINITY};
  }
  __syncwarp();
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
