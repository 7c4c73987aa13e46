// Cluster-tile Möller–Trumbore sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel path_tracer_ai_tpu/accel/pallas_ctiles.py
// `tile_sweep` (`_sweep_kernel`, `_mt_rows`). For each tile of T rays that
// share ONE cluster, every ray is tested against the cluster's S triangles
// and reduces to (best t, min triangle id at best t), or (+inf, INT32_MAX)
// on a miss.
//
// Layouts (see accel/cuda_ctiles.py):
//   tri_pack [C, 10, S] f32: rows 0-8 = v0.xyz, e1.xyz, e2.xyz; row 9 =
//            the global triangle id, bit-cast to f32 (-1 = padding slot).
//   rays     [nt, 8, T] f32: rows ox oy oz dx dy dz t_max t_min.
//   tile_cid [nt] i32 cluster id per tile.
//   t_out    [nt, T] f32, tri_out [nt, T] i32.
//
// Design. One thread block per tile, one thread per ray lane (T is a
// runtime value: 128 on the closest path, 64 in the shadow cascade). The
// block stages its cluster's 10 x S rows in shared memory (10 KB at
// S = 256), and every thread walks the S triangles reading the same
// shared word at the same time (a broadcast, no bank conflicts), keeping
// (best_t, best_tri) in registers. The TPU kernel's 8-tile groups exist
// only because Mosaic needs (8, 128) output blocks; here each tile loads
// its own cluster id, so callers pad per tile.
//
// What bounds it. Each (ray, triangle) test is ~46 f32 operations
// including one IEEE division, against 40 bytes of triangle data that are
// read once per tile from device memory and then S*T times from shared
// memory; per tile that is T*S*46 operations for 10*S*4 + 8*T*4 bytes, so
// the sweep is bound by f32 arithmetic (non-tensor-core), not by memory.
// The design spends nothing beyond the arithmetic: no intermediate leaves
// registers, and the triangle rows come from shared memory.
//
// Exactness. The arithmetic keeps traverse._mt_sweep's op order term for
// term and computes f = 1/a with IEEE division. It must be built with
// --fmad=false and without --use_fast_math or -prec-div=false: otherwise
// x*y - z*w contracts to an FMA and t moves by a few ulps. Dead lanes
// (t_max = -1) fail every test through t <= t_max; padding triangles (all
// zero) fail |a| > MT_EPSILON. The fold is the oracle's lexicographic
// rule: a passing test with t < best replaces it; one with t == best keeps
// the smaller id, so a passing test whose t is +inf still sets tri (the
// any-hit reading `tri != INT32_MAX` relies on that).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PACK_ROWS 10
#define RAY_ROWS 8
#define I32_MAX 2147483647
#define MT_EPSILON 1.0e-7f

__global__ void ctiles_sweep_kernel(const float* __restrict__ tri_pack,
                                    const float* __restrict__ rays,
                                    const int* __restrict__ tile_cid,
                                    float* __restrict__ t_out,
                                    int* __restrict__ tri_out,
                                    int s, int t_lanes, int n_clusters) {
  extern __shared__ float tri[];  // [PACK_ROWS, s]
  const int tile = blockIdx.x;
  const int cid = tile_cid[tile];
  const bool cid_ok = cid >= 0 && cid < n_clusters;
  if (cid_ok) {
    const float* src = tri_pack + (size_t)cid * PACK_ROWS * s;
    for (int i = threadIdx.x; i < PACK_ROWS * s; i += blockDim.x) {
      tri[i] = src[i];
    }
  }
  __syncthreads();

  for (int lane = threadIdx.x; lane < t_lanes; lane += blockDim.x) {
    const float* r = rays + (size_t)tile * RAY_ROWS * t_lanes + lane;
    const float ox = r[0 * t_lanes], oy = r[1 * t_lanes], oz = r[2 * t_lanes];
    const float dx = r[3 * t_lanes], dy = r[4 * t_lanes], dz = r[5 * t_lanes];
    const float tmax = r[6 * t_lanes], tmin = r[7 * t_lanes];

    float best_t = INFINITY;
    int best_tri = I32_MAX;
    const int n = cid_ok ? s : 0;
    for (int j = 0; j < n; ++j) {
      const float v0x = tri[0 * s + j], v0y = tri[1 * s + j], v0z = tri[2 * s + j];
      const float e1x = tri[3 * s + j], e1y = tri[4 * s + j], e1z = tri[5 * s + j];
      const float e2x = tri[6 * s + j], e2y = tri[7 * s + j], e2z = tri[8 * s + j];
      const int tid = __float_as_int(tri[9 * s + j]);

      // h = d x e2
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float a = e1x * hx + e1y * hy + e1z * hz;
      bool ok = fabsf(a) > MT_EPSILON;
      const float f = 1.0f / (ok ? a : 1.0f);
      const float sx = ox - v0x;
      const float sy = oy - v0y;
      const float sz = oz - v0z;
      const float u = f * (sx * hx + sy * hy + sz * hz);
      // q = s x e1
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      ok = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f);
      ok = ok && (t >= tmin) && (t <= tmax);
      if (ok) {
        if (t < best_t) {
          best_t = t;
          best_tri = tid;
        } else if (t == best_t && tid < best_tri) {
          best_tri = tid;
        }
      }
    }
    t_out[(size_t)tile * t_lanes + lane] = best_t;
    tri_out[(size_t)tile * t_lanes + lane] = best_tri;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int ctiles_sweep(const void* tri_pack, const void* rays,
                            const void* tile_cid, void* t_out, void* tri_out,
                            int nt, int s, int t_lanes, int n_clusters,
                            void* stream) {
  if (nt <= 0) return 0;
  int threads = t_lanes < 1024 ? t_lanes : 1024;
  threads = ((threads + 31) / 32) * 32;
  const size_t smem = (size_t)PACK_ROWS * s * sizeof(float);
  ctiles_sweep_kernel<<<nt, threads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)tile_cid,
      (float*)t_out, (int*)tri_out, s, t_lanes, n_clusters);
  return (int)cudaGetLastError();
}
