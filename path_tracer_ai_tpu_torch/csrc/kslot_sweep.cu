// Per-ray K-slot Möller–Trumbore sweep of the kslots backend for Hopper
// (sm_90a).
//
// No Pallas kernel stands behind it: it carries the XLA-fused SWEEP and
// RESOLVE of path_tracer_ai_tpu/accel/kslots.py `_chunk_pipeline`
// (kslots.py:165-185). Ray r tests the S triangles of each cluster
// cid[r, k] for k < n_slots[r] within [t_min[r], t_max[r]]; a ray whose
// t_max < t_min (dead, or overflowed to the fallback: t_max = -1) tests
// nothing. Closest hit: the minimum t over the passing tests, then the
// minimum triangle id among the tests at that t (the brute-force oracle's
// lexicographic rule, kslots.py:178-184), or (+inf, INT32_MAX). Any hit:
// whether some test passes.
//
// Layouts (see accel/cuda_kslots.py):
//   tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris): rows v0.xyz e1.xyz
//            e2.xyz, row 9 = the triangle id bit-cast to f32.
//   rays     [N, 8] f32: ox oy oz dx dy dz t_max t_min.
//   cid      [N, K] i32 cluster ids; n_slots [N] i32 live slots of a row.
//   out_a    [N] f32 t (closest) or u8 occluded (any hit);
//   out_b    [N] i32 tri (closest only).
//
// Design (simple first). One warp a ray: the ray's n_slots * S slots are
// walked flat, lane l taking slots l, l + 32, ... (at S = 128 a cluster is
// four trips, every lane on a neighbouring triangle, so the nine rows of a
// trip are nine coalesced 128-byte reads). Triangles come straight from the
// pack through L1/L2, with no shared staging: a ray's candidate set is its
// own, so neighbouring rays (warps) share little. Each lane keeps its own
// (t, tri) and folds it lexicographically; the warp then folds the 32
// lanes' by shuffles. The any-hit walk votes after every 32 slots and
// leaves once a lane has hit (a quarter cluster at S = 128).
//
// What may bound it: at K = 12 and S = 128 a ray requests 61 KB of
// triangle data (40 bytes a slot) against 46 f32 operations a test, and the
// 3.3 MB pack of the bench scene stays resident in the 50 MB L2, so the
// loads are served from L1 and L2 rather than device memory. How they split
// between the two has not been measured (no L2 byte counter was read).
//
// Exactness: mt.cuh's Möller–Trumbore (traverse._mt_sweep's op order, the
// reciprocal with the IEEE division's bits; build with --fmad=false); the
// lexicographic fold gives the same (t, tri) in any order of the slots,
// and the any-hit OR is exact whichever test finds the hit first.

#include "mt.cuh"

#define PACK_ROWS 10
#define KSLOT_WARPS 4  // rays (warps) a thread block

// Slot j of cluster c of an S-wide pack: its nine floats and its id.
__device__ __forceinline__ Tri load_tri(const float* __restrict__ tri_pack,
                                        int c, int j, int s, int* tid) {
  const float* p = tri_pack + (size_t)c * PACK_ROWS * s + j;
  Tri tr;
  tr.v0x = p[0 * s];
  tr.v0y = p[1 * s];
  tr.v0z = p[2 * s];
  tr.e1x = p[3 * s];
  tr.e1y = p[4 * s];
  tr.e1z = p[5 * s];
  tr.e2x = p[6 * s];
  tr.e2y = p[7 * s];
  tr.e2z = p[8 * s];
  *tid = __float_as_int(p[9 * s]);
  return tr;
}

// One test: does the ray pass triangle tr within [tmin, tmax], and at which
// t. rcp_fast where it gives the division's bits, else the division.
__device__ __forceinline__ bool mt_test(const Ray& ray, const Tri& tr,
                                        float tmin, float tmax, float* t) {
  Vec3 h, s;
  const float det = mt_det(ray, tr, &h);
  const bool det_ok = fabsf(det) > MT_EPSILON;
  const float x = det_ok ? det : 1.0f;
  const float f = fabsf(x) < RCP_FAST_BELOW ? rcp_fast(x) : 1.0f / x;
  const float u = mt_u(ray, tr, h, f, &s);
  const bool u_ok = det_ok && (u >= 0.0f) && (u <= 1.0f);
  return mt_vt(ray, tr, s, f, u, u_ok, tmin, tmax, t);
}

// The kernel's body for clusters of s triangles: a compile-time constant in
// the tuned instances (kslot_sweep_kernel<S>, where the inlined body folds
// it), a run-time value in the generic one.
template <bool CLOSEST>
__device__ __forceinline__ void kslot_ray(const float* __restrict__ tri_pack,
                                          const float* __restrict__ rays,
                                          const int* __restrict__ cid,
                                          const int* __restrict__ n_slots,
                                          void* __restrict__ out_a,
                                          int* __restrict__ out_b, int n_rays,
                                          int k_slots, int n_clusters,
                                          int s) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * KSLOT_WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // warp-uniform

  const float* rp = rays + (size_t)r * RAY_ROWS;
  const Ray ray = {rp[0], rp[1], rp[2], rp[3], rp[4], rp[5]};
  const float tmax = rp[6], tmin = rp[7];
  int ns = n_slots[r];
  ns = ns < 0 ? 0 : (ns > k_slots ? k_slots : ns);
  const int n_tests = (tmax >= tmin) ? ns * s : 0;  // dead: nothing
  const int* rc = cid + (size_t)r * k_slots;

  float best_t = INFINITY;
  int best_tri = I32_MAX;
  bool occ = false;
  for (int i0 = 0; i0 < n_tests; i0 += 32) {
    const int i = i0 + lane;
    if (i < n_tests) {
      const int c = rc[i / s];
      if (c >= 0 && c < n_clusters) {
        int tid;
        const Tri tr = load_tri(tri_pack, c, i % s, s, &tid);
        float t;
        if (mt_test(ray, tr, tmin, tmax, &t)) {
          if constexpr (CLOSEST) {
            fold_min_tri(t, tid, &best_t, &best_tri);
          } else {
            occ = true;
          }
        }
      }
    }
    if constexpr (!CLOSEST) {
      if (__any_sync(FULL_MASK, occ)) {
        occ = true;
        break;
      }
    }
  }

  if constexpr (CLOSEST) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(FULL_MASK, best_t, off);
      const int otri = __shfl_xor_sync(FULL_MASK, best_tri, off);
      if (ot < best_t || (ot == best_t && otri < best_tri)) {
        best_t = ot;
        best_tri = otri;
      }
    }
    if (lane == 0) {
      reinterpret_cast<float*>(out_a)[r] = best_t;
      out_b[r] = best_tri;
    }
  } else {
    if (lane == 0) reinterpret_cast<unsigned char*>(out_a)[r] = occ;
  }
}

template <int S, bool CLOSEST>
__global__ void __launch_bounds__(32 * KSLOT_WARPS)
    kslot_sweep_kernel(const float* __restrict__ tri_pack,
                       const float* __restrict__ rays,
                       const int* __restrict__ cid,
                       const int* __restrict__ n_slots,
                       void* __restrict__ out_a, int* __restrict__ out_b,
                       int n_rays, int k_slots, int n_clusters) {
  kslot_ray<CLOSEST>(tri_pack, rays, cid, n_slots, out_a, out_b, n_rays,
                     k_slots, n_clusters, S);
}

// The generic instance: S >= 1 at run time, the same body.
template <bool CLOSEST>
__global__ void __launch_bounds__(32 * KSLOT_WARPS)
    kslot_sweep_generic_kernel(const float* __restrict__ tri_pack,
                               const float* __restrict__ rays,
                               const int* __restrict__ cid,
                               const int* __restrict__ n_slots,
                               void* __restrict__ out_a,
                               int* __restrict__ out_b, int n_rays,
                               int k_slots, int n_clusters, int s) {
  kslot_ray<CLOSEST>(tri_pack, rays, cid, n_slots, out_a, out_b, n_rays,
                     k_slots, n_clusters, s);
}

template <int S, bool CLOSEST>
static int launch(const void* tri_pack, const void* rays, const void* cid,
                  const void* n_slots, void* out_a, void* out_b, int n_rays,
                  int k_slots, int n_clusters, cudaStream_t stream) {
  const int blocks = (n_rays + KSLOT_WARPS - 1) / KSLOT_WARPS;
  kslot_sweep_kernel<S, CLOSEST><<<blocks, 32 * KSLOT_WARPS, 0, stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid,
      (const int*)n_slots, out_a, (int*)out_b, n_rays, k_slots, n_clusters);
  return (int)cudaGetLastError();
}

template <int S, bool CLOSEST>
static int occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, kslot_sweep_kernel<S, CLOSEST>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kslot_sweep_kernel<S, CLOSEST>, 32 * KSLOT_WARPS, 0);
  *warps_per_sm = blocks * KSLOT_WARPS;
  return (int)err;
}

#define NO_INSTANCE (-1)  // no cudaError_t is negative
#define FOR_KSLOT_INSTANCES(CALL) CALL(2) CALL(128)

// Launches on `stream` over rays [0, n_rays): one warp a ray, KSLOT_WARPS
// rays a thread block. Returns the cudaError_t of the launch (0 = ok), or
// NO_INSTANCE for an S that is not compiled (S in {2, 128}).
extern "C" int kslot_sweep(const void* tri_pack, const void* rays,
                           const void* cid, const void* n_slots, void* out_a,
                           void* out_b, int n_rays, int k_slots, int s,
                           int n_clusters, int closest, void* stream) {
  if (n_rays <= 0) return 0;
  if (k_slots < 1) return NO_INSTANCE;
#define LAUNCH(S_)                                                         \
  if (s == S_)                                                             \
    return closest                                                         \
               ? launch<S_, true>(tri_pack, rays, cid, n_slots, out_a,     \
                                  out_b, n_rays, k_slots, n_clusters,      \
                                  (cudaStream_t)stream)                    \
               : launch<S_, false>(tri_pack, rays, cid, n_slots, out_a,    \
                                   out_b, n_rays, k_slots, n_clusters,     \
                                   (cudaStream_t)stream);
  FOR_KSLOT_INSTANCES(LAUNCH)
#undef LAUNCH
  return NO_INSTANCE;
}

// Registers per thread of the (S, closest) instance and the warps an SM
// holds of it.
extern "C" int kslot_sweep_occupancy(int s, int closest, int* regs,
                                     int* warps_per_sm) {
#define OCCUPANCY(S_)                                            \
  if (s == S_)                                                   \
    return closest ? occupancy<S_, true>(regs, warps_per_sm)     \
                   : occupancy<S_, false>(regs, warps_per_sm);
  FOR_KSLOT_INSTANCES(OCCUPANCY)
#undef OCCUPANCY
  return NO_INSTANCE;
}

// kslot_sweep's generic instance, with its arguments, for any S >= 1.
extern "C" int kslot_sweep_generic(const void* tri_pack, const void* rays,
                                   const void* cid, const void* n_slots,
                                   void* out_a, void* out_b, int n_rays,
                                   int k_slots, int s, int n_clusters,
                                   int closest, void* stream) {
  if (n_rays <= 0) return 0;
  if (k_slots < 1) return NO_INSTANCE;
  if (s < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + KSLOT_WARPS - 1) / KSLOT_WARPS;
#define LAUNCH(C_)                                                         \
  kslot_sweep_generic_kernel<C_><<<blocks, 32 * KSLOT_WARPS, 0,            \
                                   (cudaStream_t)stream>>>(                \
      (const float*)tri_pack, (const float*)rays, (const int*)cid,         \
      (const int*)n_slots, out_a, (int*)out_b, n_rays, k_slots, n_clusters, \
      s);
  if (closest) {
    LAUNCH(true)
  } else {
    LAUNCH(false)
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
