// The cascade stage: one stage of a cascade's loop as one cooperative
// launch (sm_90a), shared by the folds that run it.
//
// Replaces no Pallas kernel: it carries the jax.lax.while_loop of
// path_tracer_ai_tpu/accel/traverse.py `_cascade_traverse` (traverse.py:
// 439-520), whose condition XLA evaluates on the device, for the packet
// cascades (ctiles_sweep.cu: any_hit_packets and closest_hit_packets) and
// the fused cascades (fused_anyhit.cu, fused_closest.cu: any_hit_fused and
// closest_hit_fused). One launch runs one stage of a cascade to its end: on
// a slice of `size` ray blocks of T lanes, with the iteration counter k
// read from and written back to the device,
//
//   loop: act(b) = the block's active rule at k, for every block;
//         stop when sum(act) <= threshold (0 in the last stage);
//         sweep group k (its g clusters) for the sweep set and fold; k += 1.
//
// Two rules, two sweep sets (Fold::ANY). Any hit: act = k g < n_cand & some
// lane is neither occluded nor dead (t_max < 0); the sweep set is act (the
// reference's blk_on, traverse.py:950-955); the carry is occ [size, T].
// Closest: act = k g < n_cand & entry[b, min(k, kgroups - 1) g] <= the
// largest best t of a live lane; the sweep set is EVERY block with k g <
// n_cand, also those the entry rule has retired while the stage runs on
// (the reference's blk_on, traverse.py:829-842, and the fused body's,
// which sweeps the whole slice, pallas_closest.py:284-318), so the bits do
// not hang on the cull's f32 entry being truly conservative; the carry is
// (best_t, best_id) [size, T]. The fold's sweep, Fold::sweep, is what the
// launches differ in: one slot (32 lanes) of a listed block against group
// k, folded into its carry, and the slot's vote on k + 1.
//
// Design. A cooperative launch of thread blocks of STAGE_WARPS warps (grid
// = the blocks the SMs hold at once, at most what the stage can use). The
// first pass votes on k as it came in, a warp a ray block (its T / 32
// slots in turn); each later pass sweeps group k and votes on k + 1.
//
// (a) A list of the blocks that can still change. Each vote decides act
//     and whether the block is swept in the next pass: any hit, when it is
//     active (retirement is monotone, occ only grows, so a block that has
//     left never comes back and its vote is known without a read); closest,
//     when k g < n_cand (the sweep set, retired blocks included). A
//     thread block gathers its entries in shared memory and appends them
//     with one atomicAdd at the end of the pass (past LIST_CAP entries one
//     atomicAdd each). The lists alternate between two buffers of `size`
//     by the vote's parity, each starting where that parity's total, which
//     only grows, stood: nothing is reset. A block off the list is not
//     read again. A pass's teams take the list's slots one at a time from a
//     counter as they free up, so no thread block owns a block and none
//     sets the pace by holding the slow ones. The order of a list, and
//     which team takes a slot, vary from run to run; the bits do not.
// (b) W warps a slot (W in 1, 2, 4, 8 at run time), a team of one thread
//     block: the fold splits the slot's sweep over them (ctiles_sweep.cu;
//     the fused folds take W = 1). The team's warps meet at a named
//     barrier.
// (c) A block's slots may be taken by teams of several thread blocks: each
//     adds its slot's vote to the block's word (atomicOr, or atomicMax of
//     order_key) and then counts itself in; the last to arrive decides act
//     and the list entry, and clears both words for the next pass.
//
// Each pass ends in one grid-wide count (stage_count): the active total by
// the vote's parity and the list's total. A block's carry and the lists are
// written by one thread block and read by another in a later pass, so they
// are read past L1 (__ldcg), which is not coherent between SMs.
//
// A fold is a type with
//   static constexpr bool ANY;                      // the rule, as above
//   template <int S> __host__ __device__ static constexpr size_t
//       warp_bytes();                                 // a warp's buffer
//   template <int S, int T> static __device__ unsigned sweep(
//       const StageArgs&, StageShared&, int b, int slot, int k, int team,
//       int part, int w, int round, int lane, unsigned char* buf);
// S = T = 0 is a fold's generic instance (S and T at run time).

#pragma once

#include "mt.cuh"

#define STAGE_WARPS 8       // warps a thread block
#define STAGE_MIN_BLOCKS 3  // thread blocks an SM should hold: 80 registers
#define STAGE_MAX_SPLIT 8   // warps a slot at most
#define LIST_CAP 1024       // list entries a thread block gathers in a pass
#define STAGE_EARLY_SKIP 1  // opts: the fused any-hit body's early_skip
#define STAGE_SUB_SKIP 2    // opts: the fused bodies' sub_skip

struct StageArgs {
  const float* tri_pack;    // [C, 10, S] (packet), [C + 1, 16, S] (fused)
  const float* rays;        // [size, 8, T]: row 6 t_max (< 0: dead), 7 t_min
  const int* order_g;       // [size, kgroups, g]
  const int* n_cand;        // [size]
  const float* entry;       // [size, entry_stride] (closest)
  unsigned char* occ;       // [size, T] (any hit)
  float* best_t;            // [size, T] (closest)
  int* best_id;             // [size, T] (closest)
  int* k_io;                // [1]
  unsigned char* act;       // [size]: the active rule at the final k
  unsigned long long* sync; // [7] zeros: active totals by parity, arrivals,
                            // list totals by parity, unit counters by parity
  unsigned* vote;           // [size] zeros: a block's vote as slots add to it
  unsigned* arrive;         // [size] zeros: the slots that have added
  int* list;                // [2, size]: the blocks a pass sweeps, by parity
  int size, kgroups, g, s, t_lanes, n_clusters, entry_stride, threshold, w;
  int opts;                 // STAGE_EARLY_SKIP | STAGE_SUB_SKIP (fused)
  int* err;                 // [3] (fused): ids out of range, their min, max
};

// The work buffer the wrapper hands over (cuda_cascade._work), in 32-bit
// words: sync (14), vote and arrive (size each), all zeros, then the two
// lists (2 size).
#define STAGE_SYNC_WORDS 14

struct StageShared {
  float part_t[2][STAGE_WARPS][32];  // a range's fold, by the team's round
  int part_id[2][STAGE_WARPS][32];
  unsigned team_occ[2][STAGE_WARPS]; // a team's occluded lanes, by round
  int list[LIST_CAP];                // this pass's entries, gathered
  int unit[STAGE_WARPS];             // a team's unit, as its first warp took it
  unsigned count, active, flushed;
  int list_base, list_len;           // the list this pass sweeps
  unsigned long long base_at, seen, last[4];
};

// The W warps of team `team` meet (barrier 1 + team; 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int team, int w) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(w * 32) : "memory");
}

// Block b goes on the list of vote parity `par`: gathered in shared
// memory, or appended at once past LIST_CAP.
__device__ __forceinline__ void push_list(const StageArgs& a, StageShared& sh,
                                          unsigned par, int b) {
  const unsigned i = atomicAdd(&sh.count, 1u);
  if (i < LIST_CAP) {
    sh.list[i] = b;
    return;
  }
  const unsigned long long pos = atomicAdd(&a.sync[3 + par], 1ull);
  a.list[(size_t)par * a.size + pos % (unsigned long long)a.size] = b;
}

// Block b's vote v on group kn (voting: kn g < n_cand): act, the active
// count and the list of the next pass.
template <bool ANY>
__device__ __forceinline__ void decide(const StageArgs& a, StageShared& sh,
                                       unsigned par, int b, int kn,
                                       unsigned v, bool voting) {
  bool on = false;
  if (voting) {
    const int kk = kn < a.kgroups - 1 ? kn : a.kgroups - 1;
    on = ANY ? v != 0u
             : a.entry[(size_t)b * a.entry_stride + kk * a.g] <= key_float(v);
  }
  a.act[b] = on ? 1 : 0;
  if (on) atomicAdd(&sh.active, 1u);
  if (ANY ? on : voting) push_list(a, sh, par, b);
}

// Slot `slot` of block b has voted v (lane 0 of its team's first warp):
// the last of the block's slots to arrive decides.
template <bool ANY>
__device__ __forceinline__ void slot_voted(const StageArgs& a, StageShared& sh,
                                           unsigned par, int b, int slot,
                                           int slots, int kn, unsigned v,
                                           bool voting) {
  if (!voting) {  // known from n_cand: no slot adds a vote
    if (slot == 0) decide<ANY>(a, sh, par, b, kn, 0u, false);
    return;
  }
  if (slots == 1) {
    decide<ANY>(a, sh, par, b, kn, v, true);
    return;
  }
  if (ANY) {
    atomicOr(&a.vote[b], v);
  } else {
    atomicMax(&a.vote[b], v);
  }
  __threadfence();
  if (atomicAdd(&a.arrive[b], 1u) == (unsigned)slots - 1u) {
    __threadfence();
    const unsigned all = atomicExch(&a.vote[b], 0u);
    a.arrive[b] = 0u;
    decide<ANY>(a, sh, par, b, kn, all, true);
  }
}

// The first pass: block b's vote on k (no sweep), a warp a block, its
// slots in turn: any hit, some lane neither occluded nor dead; first slot,
// the largest order_key of a live lane's best t (order_key(-inf) if none).
template <bool ANY, int T>
__device__ __forceinline__ unsigned first_vote(const StageArgs& a, int b,
                                               int lane) {
  const int t_lanes = T ? T : a.t_lanes;
  const float* r = a.rays + (size_t)b * RAY_ROWS * t_lanes;
  unsigned v = ANY ? 0u : order_key(-INFINITY);
#pragma unroll 1
  for (int off = lane; off - lane < t_lanes; off += 32) {
    const bool in = off < t_lanes;
    const float tmax = in ? r[6 * t_lanes + off] : -1.0f;
    const size_t ci = (size_t)b * t_lanes + off;
    if constexpr (ANY) {
      const bool occ = in && __ldcg(a.occ + ci) != 0;
      v |= __any_sync(FULL_MASK, !occ && !(tmax < 0.0f)) ? 1u : 0u;
    } else {
      const float bt = in ? __ldcg(a.best_t + ci) : INFINITY;
      const unsigned w =
          __reduce_max_sync(FULL_MASK, order_key(tmax < 0.0f ? -INFINITY : bt));
      v = w > v ? w : v;
    }
  }
  return v;
}

// A fused fold's candidate for lane `lane`: lane j < g reads id j of block
// b's group min(k, kgroups - 1), lanes past g take the dummy, n_clusters.
// An id outside [0, n_clusters] is counted in err (word 0, and its least
// and largest value in words 1 and 2) and swept as the dummy, which no lane
// can hit: the wrapper raises once the cascade is done.
__device__ __forceinline__ int stage_cid(const StageArgs& a, int b, int k,
                                         int lane) {
  if (lane >= a.g) return a.n_clusters;
  const int kk = k < a.kgroups - 1 ? k : a.kgroups - 1;
  const int cid = a.order_g[((size_t)b * a.kgroups + kk) * a.g + lane];
  if (cid >= 0 && cid <= a.n_clusters) return cid;
  atomicAdd(a.err, 1);
  atomicMin(a.err + 1, cid);
  atomicMax(a.err + 2, cid);
  return a.n_clusters;
}

// The next unit of a sweep pass for team `team`: its first warp takes it
// from the pass's counter and hands it to the others (a team takes units
// as it frees up, so no team holds a share of the pass's slots that
// another could have swept).
__device__ __forceinline__ int take_unit(unsigned long long* taken,
                                         StageShared& sh, int team, int part,
                                         int w, int lane) {
  int u = 0;
  if (part == 0 && lane == 0) {
    const unsigned long long t = atomicAdd(taken, 1ull);
    u = t < 0x7fffffffull ? (int)t : 0x7fffffff;
  }
  if (w == 1) return __shfl_sync(FULL_MASK, u, 0);
  if (part == 0 && lane == 0) sh.unit[team] = u;
  team_sync(team, w);  // the last reader of unit[team] is past the combine
  return sh.unit[team];
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The end of a pass: the thread block's gathered list entries of vote
// parity `par` appended with one atomicAdd.
__device__ __forceinline__ void flush_list(const StageArgs& a, StageShared& sh,
                                           unsigned par) {
  __syncthreads();  // every entry is gathered
  if (threadIdx.x == 0) {
    const unsigned n = sh.count < LIST_CAP ? sh.count : LIST_CAP;
    sh.base_at = n ? atomicAdd(&a.sync[3 + par], (unsigned long long)n) : 0;
    sh.flushed = n;
    sh.count = 0u;
  }
  __syncthreads();
  int* dst = a.list + (size_t)par * a.size;
  const int base = (int)(sh.base_at % (unsigned long long)a.size);
  for (int i = threadIdx.x; i < (int)sh.flushed; i += blockDim.x) {
    const int j = base + i;
    dst[j < a.size ? j : j - a.size] = sh.list[i];
  }
}

// The grid's active blocks in vote number `n` (1, 2, ...): every thread
// block adds its count to the vote's parity total, then arrives; the vote
// is complete at n x gridDim.x arrivals. Returns the active blocks of this
// vote (the same in every thread block) and sets the list of the next
// pass (its start and length, from the parity's list total). A thread
// block reads vote n's totals after its barrier; the next add to either is
// vote n + 2's, which no thread block makes before every one has arrived
// at vote n + 1, so all read the same totals and leave at the same k.
__device__ __forceinline__ unsigned long long stage_count(const StageArgs& a,
                                                          StageShared& sh,
                                                          unsigned n) {
  __syncthreads();  // every decider has counted its blocks
  if (threadIdx.x == 0) {
    const unsigned par = n & 1u;
    atomicAdd(&a.sync[par], (unsigned long long)sh.active);
    sh.active = 0u;
    __threadfence();
    atomicAdd(&a.sync[2], 1ull);
    const unsigned long long target = (unsigned long long)n * gridDim.x;
    while (load_acquire(&a.sync[2]) < target) __nanosleep(32);
    __threadfence();
    const unsigned long long total = load_acquire(&a.sync[par]);
    sh.seen = total - sh.last[par];
    sh.last[par] = total;
    const unsigned long long listed = load_acquire(&a.sync[3 + par]);
    sh.list_base = (int)(sh.last[2 + par] % (unsigned long long)a.size);
    sh.list_len = (int)(listed - sh.last[2 + par]);
    sh.last[2 + par] = listed;
  }
  __syncthreads();
  return sh.seen;
}

template <class Fold, int S, int T>
__global__ void __launch_bounds__(STAGE_WARPS * 32, STAGE_MIN_BLOCKS)
    cascade_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StageShared sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr bool ANY = Fold::ANY;
  unsigned char* buf = smem + (size_t)warp * Fold::template warp_bytes<S>();
  const int t_lanes = T ? T : a.t_lanes;
  const int slots = (t_lanes + 31) / 32;
  if (threadIdx.x < 2 * STAGE_WARPS) {
    sh.team_occ[threadIdx.x / STAGE_WARPS][threadIdx.x % STAGE_WARPS] = 0u;
  }
  if (threadIdx.x == 0) {
    sh.count = sh.active = 0u;
    for (int i = 0; i < 4; ++i) sh.last[i] = 0ull;
  }
  __syncthreads();

  int k = *a.k_io;
  unsigned n = 0u;     // votes made
  bool sweep = false;  // the first pass only votes on k as it came in
  for (;;) {
    const unsigned par = (n + 1u) & 1u;  // this vote's parity
    if (!sweep) {
      const int stride = gridDim.x * STAGE_WARPS;
#pragma unroll 1
      for (int b = blockIdx.x * STAGE_WARPS + warp; b < a.size; b += stride) {
        const bool voting = k * a.g < a.n_cand[b];
        const unsigned v = voting ? first_vote<ANY, T>(a, b, lane) : 0u;
        if (lane == 0) decide<ANY>(a, sh, par, b, k, v, voting);
      }
    } else {
      const int w = a.w;
      const int team = warp / w, part = warp % w;
      const int* list = a.list + (size_t)(par ^ 1u) * a.size;
      const int units = sh.list_len * slots;
      // this pass takes its units from counter par; the last pass's is
      // free again (every thread block is past it), and is cleared for
      // the pass after this one
      unsigned long long* taken = &a.sync[5 + par];
      if (blockIdx.x == 0 && threadIdx.x == 0) a.sync[5 + (par ^ 1u)] = 0ull;
#pragma unroll 1
      for (int round = 0;; ++round) {
        const int u = take_unit(taken, sh, team, part, w, lane);
        if (u >= units) break;
        const int li = sh.list_base + u / slots;
        const int b = __ldcg(list + (li < a.size ? li : li - a.size));
        const int slot = u % slots;
        const bool voting = (k + 1) * a.g < a.n_cand[b];
        const unsigned v = Fold::template sweep<S, T>(
            a, sh, b, slot, k, team, part, w, round, lane, buf);
        if (part == 0 && lane == 0) {
          slot_voted<ANY>(a, sh, par, b, slot, slots, k + 1, v, voting);
        }
      }
      ++k;
    }
    flush_list(a, sh, par);
    const unsigned long long n_active = stage_count(a, sh, ++n);
    if (n_active <= (unsigned long long)a.threshold) break;
    sweep = true;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.k_io = k;
}

template <class Fold, int S>
constexpr size_t stage_smem() {
  return (size_t)STAGE_WARPS * Fold::template warp_bytes<S>();
}

template <class Fold, int S, int T>
static cudaError_t stage_blocks_per_sm(int* per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      cascade_stage_kernel<Fold, S, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stage_smem<Fold, S>());
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, cascade_stage_kernel<Fold, S, T>, STAGE_WARPS * 32,
      stage_smem<Fold, S>());
}

template <class Fold, int S, int T>
static int launch_stage(StageArgs a, cudaStream_t stream) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = stage_blocks_per_sm<Fold, S, T>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the warps a pass can use: a block each (first pass), W a slot (sweeps)
  const long long warps =
      (long long)a.size * ((a.t_lanes + 31) / 32) * a.w;
  const long long want = (warps + STAGE_WARPS - 1) / STAGE_WARPS;
  const int grid = want < (long long)per_sm * sms ? (int)want : per_sm * sms;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)cascade_stage_kernel<Fold, S, T>, dim3(grid),
      dim3(STAGE_WARPS * 32), params, stage_smem<Fold, S>(), stream);
}

template <class Fold, int S, int T>
static int stage_occupancy(int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr,
                                          cascade_stage_kernel<Fold, S, T>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  int per_sm = 0;
  err = stage_blocks_per_sm<Fold, S, T>(&per_sm);
  *warps_per_sm = per_sm * STAGE_WARPS;
  return (int)err;
}

static bool stage_split_ok(int w) {
  return w == 1 || w == 2 || w == 4 || w == STAGE_MAX_SPLIT;
}
