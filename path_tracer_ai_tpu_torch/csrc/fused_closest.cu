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
// Option sub_skip, a gate that never changes the result: a 32-triangle
// sub-slab is swept only if some lane's [t_min, min(t_max, running best)]
// segment touches its box; the bound is re-read before every sub-slab, so
// hits in near sub-slabs prune far ones inside one call. The dummy cluster
// (id C) is always skipped.
//
// Design. One thread block per ray block, one thread per lane; running
// (t, tri) in registers. Per candidate the block stages the 6 * ns box
// floats, and only if some lane touches some box at the current bounds
// (bounds only shrink, so this first vote is conservative) the 10 x S
// triangle rows (5 KB at S = 128); then one __syncthreads_or per sub-slab
// with the current bounds, and each thread walks the live sub-slabs. The
// skips are block-uniform, so every barrier is reached by all threads.
//
// What bounds it: as fused_anyhit.cu, arithmetic where anything is swept.
// Build with --fmad=false (see mt.cuh).

#include "mt.cuh"

#define GROUP 8
#define PACK_ROWS 16
#define MAX_SUBS 32

__global__ void block_closest_kernel(const float* __restrict__ tri_pack,
                                     const float* __restrict__ rays,
                                     const int* __restrict__ cid8,
                                     float* __restrict__ t_out,
                                     int* __restrict__ tri_out,
                                     int s, int t_lanes, int dummy,
                                     int sub_skip) {
  extern __shared__ float smem[];
  float* tri = smem;            // [10, s]
  float* box = smem + 10 * s;   // [ns, 6]
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const bool in_range = lane < t_lanes;
  const int ns = (s + SUB - 1) / SUB;

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float tmax = -1.0f, tmin = 0.0f;
  if (in_range) {
    const float* r = rays + (size_t)blk * RAY_ROWS * t_lanes + lane;
    ray = load_ray(r, t_lanes);
    tmax = r[6 * t_lanes];
    tmin = r[7 * t_lanes];
  }
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;

  float best_t = INFINITY;
  int best_tri = I32_MAX;
  for (int j = 0; j < GROUP; ++j) {
    // Barrier between the previous candidate's tests and this staging.
    __syncthreads();
    const int cid = cid8[(size_t)blk * GROUP + j];
    if (cid >= dummy) continue;
    const float* cluster = tri_pack + (size_t)cid * PACK_ROWS * s;

    if (sub_skip) {
      stage_boxes(box, cluster, s, ns);
      __syncthreads();
      const float cap = fminf(tmax, best_t);
      bool any = false;
      for (int k = 0; k < ns; ++k) {
        any = any || sub_slab_lane(box + k * 6, ray, invx, invy, invz, tmin,
                                   cap);
      }
      if (!__syncthreads_or(any)) continue;
    }
    stage_rows(tri, cluster, 10 * s);
    __syncthreads();
    for (int k = 0; k < ns; ++k) {
      const float cap = fminf(tmax, best_t);
      if (sub_skip &&
          !__syncthreads_or(sub_slab_lane(box + k * 6, ray, invx, invy, invz,
                                          tmin, cap))) {
        continue;
      }
      const int hi = min((k + 1) * SUB, s);
      for (int i = k * SUB; i < hi; ++i) {
        float t;
        if (mt_test(ray, tri, s, i, tmin, cap, &t)) {
          fold_min_tri(t, __float_as_int(tri[9 * s + i]), &best_t, &best_tri);
        }
      }
    }
  }
  if (in_range) {
    const size_t o = (size_t)blk * t_lanes + lane;
    t_out[o] = best_t;
    tri_out[o] = best_tri;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int block_closest(const void* tri_pack, const void* rays,
                             const void* cid8, void* t_out, void* tri_out,
                             int size, int s, int t_lanes, int dummy,
                             int sub_skip, void* stream) {
  if (size <= 0) return 0;
  const int ns = (s + SUB - 1) / SUB;
  if (ns > MAX_SUBS) return (int)cudaErrorInvalidValue;
  const int threads = ((t_lanes + 31) / 32) * 32;
  const size_t smem = (size_t)(10 * s + 6 * ns) * sizeof(float);
  block_closest_kernel<<<size, threads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid8,
      (float*)t_out, (int*)tri_out, s, t_lanes, dummy, sub_skip);
  return (int)cudaGetLastError();
}
