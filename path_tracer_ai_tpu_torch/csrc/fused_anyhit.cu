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
//   early_skip  once every lane of the block is occluded or dead, or the
//               candidate is the dummy, the remaining clusters are skipped;
//   sub_skip    each 32-triangle sub-slab is swept only if some lane's
//               [t_min, t_max] segment touches its box.
//
// Design. One thread block per ray block, one thread per lane. Per
// candidate the block first stages only the 6 * ns box floats and votes
// (__syncthreads_or per sub-slab); the 9 x S triangle rows (4.6 KB at
// S = 128) are staged only if some sub-slab is live, and each thread walks
// the live sub-slabs, reading the same shared word at the same time. A
// lane that is already occluded skips its tests. Every barrier and vote is
// reached by all threads: the skips are block-uniform.
//
// What bounds it. A swept sub-slab is T*32 tests of ~46 f32 operations for
// 1.2 KB of rows, mostly from L2: arithmetic bound where anything is swept;
// the number of sweeps depends on the data. Build with --fmad=false.

#include "mt.cuh"

#define GROUP 8
#define PACK_ROWS 16
#define MAX_SUBS 32

__global__ void block_anyhit_kernel(const float* __restrict__ tri_pack,
                                    const float* __restrict__ rays,
                                    const int* __restrict__ cid8,
                                    unsigned char* __restrict__ occ_out,
                                    int s, int t_lanes, int dummy,
                                    int early_skip, int sub_skip) {
  extern __shared__ float smem[];
  float* tri = smem;           // [9, s]
  float* box = smem + 9 * s;   // [ns, 6]
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
  const bool dead = tmax < 0.0f;
  const float invx = 1.0f / ray.dx, invy = 1.0f / ray.dy, invz = 1.0f / ray.dz;

  bool occ = false;
  for (int j = 0; j < GROUP; ++j) {
    // The vote is also the barrier between the previous candidate's tests
    // and this one's staging.
    const bool done = __syncthreads_and(occ || dead);
    const int cid = cid8[(size_t)blk * GROUP + j];
    if (early_skip && (done || cid >= dummy)) continue;
    const float* cluster = tri_pack + (size_t)cid * PACK_ROWS * s;

    unsigned live_subs = 0xffffffffu;
    if (sub_skip) {
      stage_boxes(box, cluster, s, ns);
      __syncthreads();
      live_subs = 0u;
      for (int k = 0; k < ns; ++k) {
        const bool p = sub_slab_lane(box + k * 6, ray, invx, invy, invz,
                                     tmin, tmax);
        if (__syncthreads_or(p)) live_subs |= 1u << k;
      }
      if (live_subs == 0u) continue;
    }
    stage_rows(tri, cluster, 9 * s);
    __syncthreads();
    if (!occ) {
      for (int k = 0; k < ns && !occ; ++k) {
        if (!((live_subs >> k) & 1u)) continue;
        const int hi = min((k + 1) * SUB, s);
        for (int i = k * SUB; i < hi; ++i) {
          float t;
          if (mt_test(ray, tri, s, i, tmin, tmax, &t)) {
            occ = true;
            break;
          }
        }
      }
    }
  }
  if (in_range) occ_out[(size_t)blk * t_lanes + lane] = occ ? 1 : 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int block_anyhit(const void* tri_pack, const void* rays,
                            const void* cid8, void* occ, int size, int s,
                            int t_lanes, int dummy, int early_skip,
                            int sub_skip, void* stream) {
  if (size <= 0) return 0;
  const int ns = (s + SUB - 1) / SUB;
  if (ns > MAX_SUBS) return (int)cudaErrorInvalidValue;
  const int threads = ((t_lanes + 31) / 32) * 32;
  const size_t smem = (size_t)(9 * s + 6 * ns) * sizeof(float);
  block_anyhit_kernel<<<size, threads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_pack, (const float*)rays, (const int*)cid8,
      (unsigned char*)occ, s, t_lanes, dummy, early_skip, sub_skip);
  return (int)cudaGetLastError();
}
