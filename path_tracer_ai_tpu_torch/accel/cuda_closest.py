"""The fused closest-hit cascade.

Counterpart of path_tracer_ai_tpu/accel/pallas_closest.py, the closest-hit
twin of accel.cuda_anyhit: the packet cascade's structure (coherence sort,
conservative interval cull, entry-ordered iterations with block retirement
and compaction) with GROUP = 8 candidate clusters swept per block and
iteration in ONE kernel launch. Between iterations each lane's t_max
shrinks to its best so far, and a block retires once the next group's
conservative entry exceeds every live lane's best. `block_closest` replaces
the Pallas kernel of the same name: on a CUDA tensor it launches
csrc/fused_closest.cu (or raises), on a CPU tensor it runs
`block_closest_plain`. The kernel has tuned instances for S in {64, 128,
256} and T in {64, 128} (one warp per 32 lanes of a ray block; design and
bound in the CUDA source) and a generic instance for every other S, T >= 1
(the same bits). Results are exact
with the oracle's lexicographic (t, tri) tie rule. Runs on the base accel
(no second closest-path accel).

Layouts: as accel.cuda_anyhit (tri_pack [C+1, 16, S], rays [size, 8, T]
with row 6 = min(t_max, best so far), cid8 [size * GROUP]).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel import traverse
from path_tracer_ai_tpu_torch.accel.cuda_anyhit import (
    GROUP,
    check_fused_inputs,
    pack_tris_dummy,
    prepare_fused_wave,
)
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    I32_MAX,
    combine_min_tri,
    pack_rays_tiles,
    read_occupancy,
    sub_pred,
    sub_slab_ranges,
    sweep_rows_plain,
)
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "fused_closest"

# Kernel launches since the last reset (the plain version never counts),
# and those of the generic instance among them; updated under sync.lock
# (the mesh's workers launch from several threads).
launches = 0
generic_launches = 0


def reset_launches() -> None:
    global launches, generic_launches
    with sync.lock:
        launches = generic_launches = 0


def block_closest_plain(tri_pack, rays_pack, cid8, sub_skip=True,
                        stats: Optional[dict] = None):
    """The kernel's function in eager torch -> (t [size, T] f32, tri
    [size, T] i32), with block-uniform skips: the dummy cluster always, and
    under sub_skip every sub-slab whose box no lane's [t_min, min(t_max,
    running best)] segment touches. (The kernel votes per warp of 32 lanes,
    so it sweeps a subset of these sub-slabs, to the same bits.)
    stats["tests"] counts the ray/triangle tests of the sweeps made here,
    stats["lane_tests"] those of their live lanes."""
    size, _, t_lanes = rays_pack.shape
    dev = rays_pack.device
    s = tri_pack.shape[2]
    dummy = tri_pack.shape[0] - 1
    cid = cid8.reshape(size, GROUP).long()
    best_t = torch.full((size, t_lanes), INF, dtype=torch.float32, device=dev)
    best_tri = torch.full((size, t_lanes), I32_MAX, dtype=torch.int32,
                          device=dev)
    inv = 1.0 / rays_pack[:, 3:6] if sub_skip else None
    tests = 0
    live_per_block = (rays_pack[:, 6] >= 0.0).sum(dim=1)
    lane_tests = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(GROUP):
        cj = cid[:, j]
        guard = cj < dummy
        for k, (lo, hi) in enumerate(sub_slab_ranges(s, sub_skip)):
            cap = torch.minimum(rays_pack[:, 6], best_t)
            go = guard
            if sub_skip:
                go = guard & sub_pred(tri_pack[cj, 10:16, k], rays_pack, inv,
                                      rays_pack[:, 7], cap)
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                continue
            tests += idx.numel() * t_lanes * (hi - lo)
            if stats is not None:
                lane_tests += live_per_block[idx].sum() * (hi - lo)
            kt, ktri = sweep_rows_plain(tri_pack, cj[idx], rays_pack[idx],
                                        lo, hi, t_max=cap[idx])
            best_t[idx], best_tri[idx] = combine_min_tri(
                best_t[idx], best_tri[idx], kt, ktri)
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests
        stats["lane_tests"] = stats.get("lane_tests", 0) + int(lane_tests)
    return best_t, best_tri


def _kernel():
    fn = cuda_build.load(SOURCE).block_closest
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_occupancy(s: int, t_lanes: int) -> dict:
    """Registers per thread and resident warps (ray blocks) per SM of
    block_closest's (S, T) instance (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).block_closest_occupancy,
                          s, t_lanes)


def _kernel_generic():
    fn = cuda_build.load(SOURCE).block_closest_generic
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def block_closest(tri_pack, rays_pack, cid8, sub_skip=True):
    """(t [size, T] f32 inf = miss, tri [size, T] i32 INT32_MAX = none).
    CUDA tensors launch the kernel (or raise): its tuned instance where one
    is compiled for (S, T), else its generic one; CPU tensors take the
    plain version."""
    global launches, generic_launches
    dev = rays_pack.device
    if dev.type == "cpu":
        return block_closest_plain(tri_pack, rays_pack, cid8, sub_skip)
    if dev.type != "cuda":
        raise ValueError(f"block_closest runs on cuda or cpu, not {dev}")
    size, s, t_lanes, dummy = check_fused_inputs(tri_pack, rays_pack, cid8)
    t_out = torch.empty((size, t_lanes), dtype=torch.float32, device=dev)
    tri_out = torch.empty((size, t_lanes), dtype=torch.int32, device=dev)
    if size == 0:
        return t_out, tri_out
    err, ran_generic = cuda_build.launch_instance(
        _kernel(), _kernel_generic(), dev,
        (tri_pack.data_ptr(), rays_pack.data_ptr(), cid8.data_ptr(),
         t_out.data_ptr(), tri_out.data_ptr(), size, s, t_lanes, dummy,
         int(sub_skip)))
    if err != 0:
        raise RuntimeError(f"block_closest launch failed: cudaError {err}")
    with sync.lock:
        launches += 1
        generic_launches += ran_generic
    return t_out, tri_out


def closest_hit_fused(accel, origins, directions, t_min, t_max,
                      block_size: int = 128, sort_mode: str = "octorig",
                      sub_skip: bool = True, kernel_chunk: int = 8192,
                      sort: bool = True, exact_cull: int = 0,
                      tri_pack=None) -> PacketHit:
    """Closest hit over a wave through the fused cascade.

    Exact per ray; accepts any wave size (pads to a power-of-two block
    count with dead lanes). Each iteration sweeps the ACTIVE blocks only,
    `kernel_chunk` blocks per launch. tri_pack: pack_tris_dummy(accel), if
    the caller holds one. exact_cull=K: the per-ray-exact cull
    (cuda_anyhit.prepare_fused_wave); its candidates keep the
    conservative entry order, so the front-to-back stop still holds, and
    the result is the same."""
    n0 = origins.shape[0]
    dev = origins.device
    origins, directions, t_max, perm, n_cand, entry, order_g = (
        prepare_fused_wave(accel, origins, directions, t_max, block_size,
                           sort, sort_mode, t_min, exact_cull))
    nb = n_cand.shape[0]
    n = nb * block_size
    max_k = order_g.shape[1] - 1
    if tri_pack is None:
        tri_pack = pack_tris_dummy(accel)
    rays_pack = pack_rays_tiles(origins, directions, t_max, block_size,
                                t_min=float(t_min))

    def active_fn(k, blocks, carry):
        # Front-to-back stop at block granularity: once the next group's
        # conservative entry exceeds every live lane's best, no later
        # candidate can improve the block. Dead lanes (t_max < 0, ray row
        # 6) must not gate with their inf.
        rays_pk, nc, ent, _ordg = blocks
        best_eff = torch.where(rays_pk[:, 6, :] < 0.0, -INF, carry[0])
        entry_k = ent[:, min(k, max_k) * GROUP]
        return (k * GROUP < nc) & (entry_k <= best_eff.amax(dim=1))

    def sweep_update(k, blocks, carry, idx):
        rays_pk, _nc, _ent, ordg = blocks
        best_t, best_id = carry
        cid8 = ordg[idx, min(k, max_k)]                    # [n_act, GROUP]
        rp = rays_pk[idx]
        # t_max shrinks to the running best; dead lanes stay at -1.
        rp[:, 6, :] = torch.minimum(rp[:, 6, :], best_t[idx])
        for lo in range(0, idx.numel(), kernel_chunk):
            hi = lo + kernel_chunk
            sl = idx[lo:hi]
            kt, ktri = block_closest(tri_pack, rp[lo:hi],
                                     cid8[lo:hi].reshape(-1),
                                     sub_skip=sub_skip)
            # in place: the carry is this call's own
            best_t[sl], best_id[sl] = combine_min_tri(
                best_t[sl], best_id[sl], kt, ktri)
        return best_t, best_id

    carry, blk_index = traverse._cascade_traverse(
        (rays_pack, n_cand, entry, order_g),
        (torch.full((nb, block_size), INF, dtype=torch.float32, device=dev),
         torch.full((nb, block_size), I32_MAX, dtype=torch.int32, device=dev)),
        sweep_update,
        active_fn,
    )
    best_t, best_id = (
        traverse._unsort(traverse._unpermute_blocks(a, blk_index).reshape(n),
                         perm)[:n0] for a in carry)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t, tri=torch.where(hit, best_id, -1))
