// The packet cascades' interval cull for Hopper (sm_90a): packet_cull.
//
// Replaces no Pallas kernel: it is the XLA-fused body of
// path_tracer_ai_tpu/accel/traverse.py `_block_candidates` (traverse.py:
// 171-202, with `_ray_block_bounds` and `_interval_slab`, :100-165), the
// conservative cull of every block of R rays against every cluster box
// that the packet cascades (any_hit_packets, closest_hit_packets), the
// pallas route, the fused cascades and the exact cull's conservative list
// start from. JAX runs it as one fusion feeding one sort; the port's plain
// version (accel/cuda_cull.py block_candidates_plain) as some 55 eager ops
// over [rows, C] temporaries and a segmented sort.
//
// Layouts (accel/cuda_cull.py block_candidates):
//   o_blk, d_blk [nb, R, 3] f32; tm_blk [nb, R] f32 (t_max; negative: a
//   dead lane); bmin, bmax [C, 3] f32.
//   order [nb, C] i32: the cluster ids by ascending conservative entry
//   (stable: equal entries keep ascending ids), candidates first;
//   n_cand [nb] i32; entry_sorted [nb, C] f32, the entries in that order
//   (null: not written).
//
// Per ray block, exactly what JAX computes:
//   1. the bounds of its live lanes and tmax_ub (csrc/interval.cuh,
//      shared with the worklist's cull, worklist_cull.cu);
//   2. per cluster, _interval_slab op for op (interval.cuh's
//      slab_candidate: the IEEE quotients, the NaN flags, the axes that
//      span 0 skipped), cand = lb <= ub & ub >= 0 & lb <= tmax_ub,
//      entry = cand ? max(lb, 0) : +inf;
//   3. the stable ascending sort of the entries.
// Signed zeros reach the entry, which is written as +0.0 (max(lb, 0) may
// be either zero; both are one key).
//
// Design: one thread block (128 threads) a ray block. The lanes are
// reduced per warp with shuffles, then across warps in shared memory.
// Threads stride the clusters and keep each entry's bits (the f32 bits of
// a non-negative float order as unsigned ints) in shared memory. A chunked
// block scan over the ids then places, in ascending id order, every +inf
// entry at the tail of the row (written straight out: they keep ascending
// ids, candidates with lb = +inf among them) and every finite one as a
// 64-bit key (entry bits << 32 | id) at the head of a buffer, which a
// bitonic sort over the next power of two of their count puts in order:
// one warp's shuffles up to 32 keys (the main path's shadow blocks hold
// 15-25 on average), the whole block over the buffer past that. A pair
// leaves the interval test at the first axis after which it cannot be a
// candidate (lb only grows, ub only shrinks, a NaN stays flagged).
// The buffer and the bits take 8 * pow2(C) + 4 * C bytes of shared memory:
// up to C = 16,384 (196,608 bytes); past that each thread block sorts in a
// device-memory scratch slot that the wrapper allocates, and the grid is
// SCRATCH_BLOCKS thread blocks striding the ray blocks.
//
// What bounds it: the bytes on the main path (the rays in, 28 B a lane;
// order out, 4 B a pair; entry_sorted 4 B a pair where written) rather
// than the operations (chip_smoke.py PCULL_AXIS_OPS, PCULL_PAIR_OPS): 14
// f32 operations a (block, cluster) pair and axis whose direction interval
// does not span 0 (2 subtractions, 4 divisions, 6 min / max for the
// quotients' bounds, 2 for lb and ub), 5 a pair (the 3 compares of the
// candidate test, the entry's max and select), and the sort's n log2 n
// compares at n finite entries. The design moves each input and output
// byte once; what it spends beyond the bound is the divisions' and the
// barriers' latency.

#include "interval.cuh"
#include "ray_slab.cuh"

#define CULL_THREADS 128
#define CULL_WARPS (CULL_THREADS / 32)
#define INF_BITS 0x7f800000u
// thread blocks of the grid when the sort runs in device memory
#define SCRATCH_BLOCKS 1024
// dynamic shared memory a thread block may take (227 KB less the static
// arrays' room)
#define SMEM_LIMIT (227 * 1024 - 1024)

static __host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of one thread block's sort buffer (8 * pow2(C), the keys) and
// entry bits (4 * C), rounded up to 16.
static __host__ __device__ size_t sort_bytes(int c) {
  const size_t b = 8 * (size_t)pow2_at_least(c) + 4 * (size_t)c;
  return (b + 15) & ~(size_t)15;
}

__global__ void __launch_bounds__(CULL_THREADS)
    packet_cull_kernel(const float* __restrict__ o_blk,
                       const float* __restrict__ d_blk,
                       const float* __restrict__ tm_blk,
                       const float* __restrict__ bmin,
                       const float* __restrict__ bmax, int nb, int r, int c,
                       int* __restrict__ order, int* __restrict__ n_cand,
                       float* __restrict__ entry_sorted,
                       unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char cull_smem[];
  __shared__ float red[CULL_WARPS][BOUNDS_N];
  __shared__ float bnd[BOUNDS_N];
  __shared__ int counts[2];  // candidates, finite entries
  __shared__ int warp_fin[CULL_WARPS], warp_inf[CULL_WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* buf =
      scratch ? scratch + (size_t)blockIdx.x * sort_bytes(c) : cull_smem;
  const int cap2 = pow2_at_least(c);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(buf);
  unsigned* ebits = reinterpret_cast<unsigned*>(buf + 8 * (size_t)cap2);

  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    // 1. bounds (interval.cuh): each warp's lanes, then across the warps
    float v[BOUNDS_N];
    unsigned nan_bits;
    bounds_init(v, &nan_bits);
    for (int l = tid; l < r; l += CULL_THREADS) {
      const size_t i = (size_t)blk * r + l;
      bounds_add_lane(v, &nan_bits, o_blk + 3 * i, d_blk + 3 * i, tm_blk[i]);
    }
    bounds_warp_reduce(v, &nan_bits);
    bounds_put_nan(v, nan_bits);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < BOUNDS_N; ++i) red[warp][i] = v[i];
    }
    if (tid < 2) counts[tid] = 0;
    __syncthreads();
    if (tid < BOUNDS_N) {
      float x = red[0][tid];
      for (int w = 1; w < CULL_WARPS; ++w)
        x = tid < BOUNDS_MINS ? nan_min(x, red[w][tid])
                              : nan_max(x, red[w][tid]);
      bnd[tid] = x;
    }
    __syncthreads();
    const SlabBlock sb = slab_block(bnd);

    // 2. every cluster's entry (interval.cuh's test), its bits kept;
    // candidates and finite entries counted
    int n_c = 0, n_f = 0;
    for (int k = tid; k < c; k += CULL_THREADS) {
      float lb;
      const bool cand = slab_candidate(sb, bmin + 3 * k, bmax + 3 * k, &lb);
      const float entry = cand ? (lb > 0.0f ? lb : 0.0f) : INFINITY;
      const unsigned bits = __float_as_uint(entry);
      ebits[k] = bits;
      n_c += cand;
      n_f += bits < INF_BITS;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_c += __shfl_xor_sync(FULL_MASK, n_c, off);
      n_f += __shfl_xor_sync(FULL_MASK, n_f, off);
    }
    if (lane == 0) {
      atomicAdd(&counts[0], n_c);
      atomicAdd(&counts[1], n_f);
    }
    __syncthreads();
    const int n_fin = counts[1];
    int* ord = order + (size_t)blk * c;
    float* ent = entry_sorted ? entry_sorted + (size_t)blk * c : nullptr;
    if (tid == 0) n_cand[blk] = counts[0];

    // 3. a scan over the ids in ascending order: the +inf entries to the
    // tail, the finite ones as keys to the buffer's head
    int fin_base = 0, inf_base = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < c; base += CULL_THREADS) {
      const int k = base + tid;
      const unsigned bits = k < c ? ebits[k] : INF_BITS;
      const bool fin = k < c && bits < INF_BITS;
      const bool inf = k < c && bits >= INF_BITS;
      const unsigned mf = __ballot_sync(FULL_MASK, fin);
      const unsigned mi = __ballot_sync(FULL_MASK, inf);
      if (lane == 0) {
        warp_fin[warp] = __popc(mf);
        warp_inf[warp] = __popc(mi);
      }
      __syncthreads();
      int pf = fin_base, pi = inf_base, tf = 0, ti = 0;
      for (int w = 0; w < CULL_WARPS; ++w) {
        if (w == warp) {
          pf += tf;
          pi += ti;
        }
        tf += warp_fin[w];
        ti += warp_inf[w];
      }
      if (fin) {
        keys[pf + __popc(mf & below)] =
            ((unsigned long long)bits << 32) | (unsigned)k;
      } else if (inf) {
        const int pos = n_fin + pi + __popc(mi & below);
        ord[pos] = k;
        if (ent) ent[pos] = INFINITY;
      }
      fin_base += tf;
      inf_base += ti;
      __syncthreads();  // warp_fin / warp_inf are rewritten next chunk
    }

    // 4. the finite keys sorted (bitonic over the next power of two,
    // padded with keys above every real one), then written out: up to 32
    // by one warp in registers, exchanging by shuffles (no block barrier),
    // past that by the block in the buffer
    if (n_fin > 0 && n_fin <= 32) {
      if (warp == 0) {
        unsigned long long key = lane < n_fin ? keys[lane] : ~0ull;
        for (int size = 2; size <= 32; size <<= 1) {
          for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const unsigned long long other =
                __shfl_xor_sync(FULL_MASK, key, stride);
            // the lower lane of a pair keeps the smaller key where its
            // run ascends, the larger where it descends
            const bool keep_min =
                ((lane & stride) == 0) == ((lane & size) == 0);
            key = keep_min ? (other < key ? other : key)
                           : (other > key ? other : key);
          }
        }
        if (lane < n_fin) {
          ord[lane] = (int)(unsigned)(key & 0xffffffffull);
          if (ent) ent[lane] = __uint_as_float((unsigned)(key >> 32));
        }
      }
    } else if (n_fin > 32) {
      const int p = pow2_at_least(n_fin);
      for (int i = n_fin + tid; i < p; i += CULL_THREADS) keys[i] = ~0ull;
      __syncthreads();
      for (int size = 2; size <= p; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int i = tid; i < p; i += CULL_THREADS) {
            const int j = i ^ stride;
            if (j > i) {
              const unsigned long long x = keys[i], y = keys[j];
              if ((x > y) == ((i & size) == 0)) {
                keys[i] = y;
                keys[j] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int i = tid; i < n_fin; i += CULL_THREADS) {
        const unsigned long long key = keys[i];
        ord[i] = (int)(unsigned)(key & 0xffffffffull);
        if (ent) ent[i] = __uint_as_float((unsigned)(key >> 32));
      }
    }
    __syncthreads();  // counts, ebits and keys are reused by the next block
  }
}

// Bytes of device-memory scratch the wrapper must pass for (nb, c): 0 when
// a thread block's sort fits its shared memory.
extern "C" long long packet_cull_scratch_bytes(int nb, int c) {
  if (c < 1 || sort_bytes(c) <= SMEM_LIMIT) return 0;
  const int grid = nb < SCRATCH_BLOCKS ? nb : SCRATCH_BLOCKS;
  return (long long)grid * (long long)sort_bytes(c);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// entry_sorted may be null (not written); scratch must be
// packet_cull_scratch_bytes(nb, c) bytes (null when that is 0).
extern "C" int packet_cull(const void* o_blk, const void* d_blk,
                           const void* tm_blk, const void* bmin,
                           const void* bmax, int nb, int r, int c,
                           void* order, void* n_cand, void* entry_sorted,
                           void* scratch, void* stream) {
  if (nb <= 0) return 0;
  if (r < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const bool shared = sort_bytes(c) <= SMEM_LIMIT;
  if (!shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = shared ? sort_bytes(c) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packet_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = shared ? nb : (nb < SCRATCH_BLOCKS ? nb : SCRATCH_BLOCKS);
  packet_cull_kernel<<<grid, CULL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)o_blk, (const float*)d_blk, (const float*)tm_blk,
      (const float*)bmin, (const float*)bmax, nb, r, c, (int*)order,
      (int*)n_cand, (float*)entry_sorted,
      shared ? nullptr : (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

// Registers per thread and resident warps per SM at c clusters.
extern "C" int packet_cull_occupancy(int c, int* regs, int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, packet_cull_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  const size_t smem = sort_bytes(c) <= SMEM_LIMIT ? sort_bytes(c) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(packet_cull_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, packet_cull_kernel, CULL_THREADS, smem);
  *warps_per_sm = blocks * CULL_WARPS;
  return (int)err;
}

// ---- the exact shadow cull: exact_cull --------------------------------------
//
// Replaces no Pallas kernel: it is the XLA-fused body of
// path_tracer_ai_tpu/accel/traverse.py `_exact_block_candidates`
// (traverse.py:205-397), the per-lane exact OR-union of a ray block's
// candidate clusters through the 2-level hierarchy, which the packet
// cascades and the fused cascades take at exact_cull=K (ksup). The port's
// plain version (accel/cuda_cull.py exact_cull_plain) runs it as eager
// [rows, R, K] slab temporaries, a stable argsort and gathers.
//
// It runs after packet_cull on the same rays (with entries): the
// conservative row is the overflow blocks' list and gives each exact id
// its entry; this kernel overwrites the rows of the blocks within the
// super shortlist in place.
//
// Layouts (accel/cuda_cull.py exact_cull): the rays as packet_cull's;
// sbmin, sbmax [Cs, 3]; cbmin, cbmax [Cs, ss, 3] (the padding children of
// a partly filled last super inverted); order [nb, C] i32, n_cand [nb]
// i32 and entry_sorted [nb, C] f32 hold packet_cull's tables on entry.
//
// Per ray block, exactly what JAX computes (kx = min(ksup, Cs), kchild =
// kx * ss):
//   1. each live lane (t_max >= 0; its window [t_min, t_max]) against the
//      Cs supers, by ray_slab.cuh's perray_slab (the sign-select slab of
//      JAX's slab_lanes gives its bits), OR'd over the lanes: n_sup
//      supers pass. n_sup > kx: an overflow block, whose conservative row
//      stays as it is;
//   2. the shortlist, the n_sup supers in ascending id, in slots of ss:
//      slot j = (shortlist position s, child k), cluster id sup[s] * ss +
//      k; each lane against the shortlisted children, OR'd: the exact ids
//      (ids >= C dropped; slots past n_sup * ss hold no id);
//   3. each exact id's conservative entry, read off the conservative row
//      (its finite prefix, the first n_cand entries, holds every finite
//      one; an id found nowhere there has +inf);
//   4. JAX's stable argsort of the whole kchild slot row: the key is
//      (entry, slot), the sentinel slots (no exact id) at +inf. The row's
//      position p holds the slot of rank p: its id (C - 1 for a sentinel)
//      and entry; positions past kchild hold (C - 1, +inf), and a row of
//      kchild >= C slots is cut to C. n_cand = the exact ids.
// An exact id whose conservative entry is +inf (the block's interval
// test failed where a lane's own test passed) ranks among the sentinels
// by its slot, as in JAX: it can land past n_cand.
// Dead blocks need no host count (JAX's live_blocks): a block with no
// live lane has n_sup 0 and gets the row (C - 1, +inf) and n_cand 0.
//
// Design: one thread block a ray block, a lane a thread (R up to 1024
// threads, lanes strided past that). The box tests' results are OR'd per
// word of 32 boxes with a warp reduction and one shared atomicOr a warp.
// The ranks: each finite slot counts the finite slots before it by key
// (n_fin^2 compares a block, n_fin the block's exact ids of finite entry:
// 15-25 on the main path), each +inf slot's rank is n_fin plus the +inf
// slots before it (a popcount prefix). Shared memory: the super and child
// masks, the shortlist, the slots' entries and the finite list, 4 (2 Cs/32
// + kx + 3 kchild/32 + 3 kchild) bytes.
//
// What bounds it: the box tests' operations (each live lane's Cs super
// tests, plus n_sup * ss children in an in-cap block; chip_smoke.py
// PERRAY_TEST_OPS a test) against the bytes (the rays in, the conservative
// prefix read, the in-cap rows written).

#define EXACT_MAX_THREADS 1024

struct ExactArgs {
  const float* o_blk;
  const float* d_blk;
  const float* tm_blk;
  const float* sbmin;  // [Cs, 3]
  const float* sbmax;
  const float* cbmin;  // [Cs, ss, 3]
  const float* cbmax;
  int* order;          // [nb, C], packet_cull's on entry
  int* n_cand;         // [nb]
  float* entry;        // [nb, C]
  float t_min;
  int nb, r, c, cs, ss, kx;
};

static __host__ __device__ int words_of(int n) { return (n + 31) >> 5; }

// Bytes of one thread block's dynamic shared memory.
static __host__ __device__ size_t exact_smem(int cs, int kx, int ss) {
  const int kchild = kx * ss;
  return 4 * ((size_t)2 * words_of(cs) + kx + 3 * (size_t)words_of(kchild) +
              3 * (size_t)kchild);
}

// Lane l of block blk: its ray, and whether its window [t_min, t_max] is
// not empty (a dead lane, t_max < 0 or NaN, gets hi0 = -inf).
__device__ __forceinline__ bool exact_lane(const ExactArgs& a, int blk, int l,
                                           RayIn* ray) {
  if (l >= a.r) return false;
  const size_t i = (size_t)blk * a.r + l;
  const float tm = __ldg(a.tm_blk + i);
  *ray = load_ray(a.o_blk, a.d_blk, i, a.t_min, tm >= 0.0f ? tm : -INFINITY);
  return ray->hi0 >= ray->lo0;
}

__global__ void __launch_bounds__(EXACT_MAX_THREADS)
    exact_cull_kernel(const ExactArgs a) {
  extern __shared__ __align__(16) unsigned char exact_smem_buf[];
  __shared__ int s_nsup, s_ncons, s_nfin, s_nex;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int ws = words_of(a.cs), kchild = a.kx * a.ss;
  const int wk = words_of(kchild);
  unsigned* sup_mask = reinterpret_cast<unsigned*>(exact_smem_buf);
  int* sup_pre = reinterpret_cast<int*>(sup_mask + ws);
  int* sup_ids = sup_pre + ws;
  unsigned* child_mask = reinterpret_cast<unsigned*>(sup_ids + a.kx);
  unsigned* fin_mask = child_mask + wk;
  int* fin_pre = reinterpret_cast<int*>(fin_mask + wk);
  float* ent = reinterpret_cast<float*>(fin_pre + wk);
  int* fin_slot = reinterpret_cast<int*>(ent + kchild);
  float* fin_e = reinterpret_cast<float*>(fin_slot + kchild);
  const int rounds = (a.r + nt - 1) / nt;
  const unsigned below = (1u << lane) - 1u;

  for (int w = tid; w < ws; w += nt) sup_mask[w] = 0u;
  for (int w = tid; w < wk; w += nt) child_mask[w] = fin_mask[w] = 0u;
  for (int j = tid; j < kchild; j += nt) ent[j] = INFINITY;
  if (tid == 0) s_ncons = a.n_cand[blk];
  __syncthreads();

  // 1. each live lane against the supers, OR'd over the block
  for (int round = 0; round < rounds; ++round) {
    RayIn ray;
    const bool live = exact_lane(a, blk, round * nt + tid, &ray);
    if (!__syncthreads_or(live)) continue;
    for (int w = 0; w < ws; ++w) {
      unsigned bits = 0u;
      if (live) {
        const int n = a.cs - 32 * w < 32 ? a.cs - 32 * w : 32;
        for (int b = 0; b < n; ++b) {
          float lo[3], hi[3];
          load_box(a.sbmin + 3 * (size_t)(32 * w + b), lo);
          load_box(a.sbmax + 3 * (size_t)(32 * w + b), hi);
          if (perray_slab(ray, lo, hi)) bits |= 1u << b;
        }
      }
      bits = __reduce_or_sync(FULL_MASK, bits);
      if (lane == 0 && bits) atomicOr(&sup_mask[w], bits);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int w = 0; w < ws; ++w) {
      sup_pre[w] = acc;
      acc += __popc(sup_mask[w]);
    }
    s_nsup = acc;
  }
  __syncthreads();
  const int n_sup = s_nsup;
  if (n_sup > a.kx) return;  // overflow: the conservative row stays
  int* ord = a.order + (size_t)blk * a.c;
  float* en = a.entry + (size_t)blk * a.c;
  if (n_sup == 0) {  // no live lane meets a super: no exact id
    for (int j = tid; j < a.c; j += nt) {
      ord[j] = a.c - 1;
      en[j] = INFINITY;
    }
    if (tid == 0) a.n_cand[blk] = 0;
    return;
  }

  // 2. the shortlist (ascending ids), then each live lane against its
  // children, OR'd over the block; ids >= C dropped
  for (int w = tid; w < ws; w += nt) {
    unsigned bits = sup_mask[w];
    int rank = sup_pre[w];
    while (bits) {
      sup_ids[rank++] = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
  }
  __syncthreads();
  const int n_slots = n_sup * a.ss;
  const int wv = words_of(n_slots);
  for (int round = 0; round < rounds; ++round) {
    RayIn ray;
    const bool live = exact_lane(a, blk, round * nt + tid, &ray);
    if (!__syncthreads_or(live)) continue;
    for (int w = 0; w < wv; ++w) {
      unsigned bits = 0u;
      if (live) {
        const int n = n_slots - 32 * w < 32 ? n_slots - 32 * w : 32;
        int s = (32 * w) / a.ss, k = 32 * w - s * a.ss;
        for (int b = 0; b < n; ++b) {
          const size_t child = (size_t)sup_ids[s] * a.ss + k;
          if (child < (size_t)a.c) {
            float lo[3], hi[3];
            load_box(a.cbmin + 3 * child, lo);
            load_box(a.cbmax + 3 * child, hi);
            if (perray_slab(ray, lo, hi)) bits |= 1u << b;
          }
          if (++k == a.ss) {
            k = 0;
            ++s;
          }
        }
      }
      bits = __reduce_or_sync(FULL_MASK, bits);
      if (lane == 0 && bits) atomicOr(&child_mask[w], bits);
    }
  }
  __syncthreads();

  // 3. each exact id's entry, off the conservative row's finite prefix
  // (read before any write to the row)
  for (int j = tid; j < s_ncons; j += nt) {
    const float e = en[j];
    if (!(e < INFINITY)) continue;
    const int id = ord[j];
    const int sx = id / a.ss;
    const unsigned m = sup_mask[sx >> 5], bit = 1u << (sx & 31);
    if (!(m & bit)) continue;
    const int slot = (sup_pre[sx >> 5] + __popc(m & (bit - 1u))) * a.ss +
                     (id - sx * a.ss);
    if (child_mask[slot >> 5] >> (slot & 31) & 1u) ent[slot] = e;
  }
  __syncthreads();

  // 4. the finite slots: a mask, its prefix and the list in slot order
  for (int base = 0; base < kchild; base += nt) {
    const int j = base + tid;
    const bool fin = j < kchild && ent[j] < INFINITY;
    const unsigned m = __ballot_sync(FULL_MASK, fin);
    if (lane == 0 && (j >> 5) < wk) fin_mask[j >> 5] = m;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0, nex = 0;
    for (int w = 0; w < wk; ++w) {
      fin_pre[w] = acc;
      acc += __popc(fin_mask[w]);
      nex += __popc(child_mask[w]);
    }
    s_nfin = acc;
    s_nex = nex;
  }
  __syncthreads();
  for (int j = tid; j < kchild; j += nt) {
    const unsigned m = fin_mask[j >> 5], bit = 1u << (j & 31);
    if (m & bit) {
      const int i = fin_pre[j >> 5] + __popc(m & (bit - 1u));
      fin_slot[i] = j;
      fin_e[i] = ent[j];
    }
  }
  __syncthreads();

  // 5. each slot's rank by (entry, slot), and the row
  const int n_fin = s_nfin;
  for (int j = tid; j < kchild; j += nt) {
    const int w = j >> 5;
    const unsigned bit = 1u << (j & 31);
    const bool fin = fin_mask[w] & bit;
    int p;
    float e = INFINITY;
    if (fin) {
      e = ent[j];
      p = 0;
      for (int i = 0; i < n_fin; ++i) {
        const float x = fin_e[i];
        p += x < e || (x == e && fin_slot[i] < j);
      }
    } else {
      p = n_fin + j - (fin_pre[w] + __popc(fin_mask[w] & (bit - 1u)));
    }
    if (p < a.c) {
      int id = a.c - 1;
      if (child_mask[w] & bit) {
        const int s = j / a.ss;
        id = sup_ids[s] * a.ss + (j - s * a.ss);
      }
      ord[p] = id;
      en[p] = e;
    }
  }
  for (int j = kchild + tid; j < a.c; j += nt) {
    ord[j] = a.c - 1;
    en[j] = INFINITY;
  }
  if (tid == 0) a.n_cand[blk] = s_nex;
}

// Bytes of dynamic shared memory a thread block of exact_cull takes (the
// wrapper refuses a shape past EXACT_SMEM_LIMIT).
extern "C" long long exact_cull_smem_bytes(int cs, int kx, int ss) {
  return (long long)exact_smem(cs, kx, ss);
}

static int exact_threads(int r) {
  const int t = (r + 31) / 32 * 32;
  return t < EXACT_MAX_THREADS ? t : EXACT_MAX_THREADS;
}

static cudaError_t exact_smem_attribute(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(exact_cull_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// order, n_cand and entry hold packet_cull's tables of the same rays.
extern "C" int exact_cull(const void* o_blk, const void* d_blk,
                          const void* tm_blk, float t_min, const void* sbmin,
                          const void* sbmax, const void* cbmin,
                          const void* cbmax, int nb, int r, int c, int cs,
                          int ss, int kx, void* order, void* n_cand,
                          void* entry, void* stream) {
  if (nb <= 0) return 0;
  if (r < 1 || c < 1 || cs < 1 || ss < 1 || kx < 1 || kx > cs ||
      (long long)cs * ss < c || entry == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = exact_smem(cs, kx, ss);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t err = exact_smem_attribute(smem);
  if (err != cudaSuccess) return (int)err;
  const ExactArgs a = {(const float*)o_blk, (const float*)d_blk,
                       (const float*)tm_blk, (const float*)sbmin,
                       (const float*)sbmax, (const float*)cbmin,
                       (const float*)cbmax, (int*)order, (int*)n_cand,
                       (float*)entry, t_min, nb, r, c, cs, ss, kx};
  exact_cull_kernel<<<nb, exact_threads(r), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers per thread and resident warps per SM at blocks of r rays.
extern "C" int exact_cull_occupancy(int r, int cs, int kx, int ss, int* regs,
                                    int* warps_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, exact_cull_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  const size_t smem = exact_smem(cs, kx, ss);
  err = exact_smem_attribute(smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  const int threads = exact_threads(r);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, exact_cull_kernel, threads, smem);
  *warps_per_sm = blocks * threads / 32;
  return (int)err;
}
