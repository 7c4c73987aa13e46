"""The fused any-hit cascade for shadow waves.

Counterpart of path_tracer_ai_tpu/accel/pallas_anyhit.py. `any_hit_fused`
keeps the packet cascade's structure (coherence sort, conservative interval
cull, block retirement and compaction: traverse._cascade_stages) and
sweeps GROUP = 8 candidate clusters per block and iteration; on the card
each stage of its loop is one launch of the fused stage kernel
(accel.cuda_cascade.fused_stage), whose sweep is the body of
block_anyhit's generic instance.
`block_anyhit` replaces the Pallas kernel of the same name: on a
CUDA tensor it launches csrc/fused_anyhit.cu (or raises), on a CPU tensor it
runs `block_anyhit_plain`, the same function as eager torch ops. The kernel
has tuned instances for S in {64, 128, 256} and T in {64, 128} (one warp
per 32 lanes of a ray block; design and bound in the CUDA source) and a
generic instance for every other S, T >= 1 (the same bits).

Layouts:
  tri_pack [C+1, 16, S] f32 (pack_tris_dummy): cuda_ctiles.pack_tris16 plus
           an all-zero dummy cluster C with inverted sub-slab boxes, the
           no-hit sink that candidate-list padding points at.
  rays     [size, 8, T] f32 (cuda_ctiles.pack_rays_tiles; row 7 = t_min).
  cid8     [size * GROUP] i32, block i's candidates at i*GROUP.., in [0, C].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles, traverse
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    RAY_ROWS,
    SUB,
    _check,
    n_subs,
    pack_rays_tiles,
    read_occupancy,
    sub_pred,
    sub_slab_ranges,
    sweep_rows_plain,
)
from path_tracer_ai_tpu_torch.core.types import RAY_TMIN
from path_tracer_ai_tpu_torch.utils import sync

GROUP = 8  # candidate clusters consumed per block per cascade iteration
PACK_ROWS = 16
SOURCE = "fused_anyhit"

# Kernel launches since the last reset (the plain version never counts),
# and those of the generic instance among them; updated under sync.lock
# (the mesh's workers launch from several threads).
launches = 0
generic_launches = 0


def reset_launches() -> None:
    global launches, generic_launches
    with sync.lock:
        launches = generic_launches = 0


def pack_tris_dummy(accel) -> torch.Tensor:
    """[C+1, 16, S] triangle pack with an all-zero dummy cluster at index C.
    A zero triangle has determinant 0 and fails |a| > MT_EPSILON on every
    lane; the dummy's sub-slab boxes are inverted so sub_skip never sweeps
    it."""
    pack = cuda_ctiles.pack_tris16(accel)
    dummy = torch.zeros((1,) + pack.shape[1:], dtype=pack.dtype,
                        device=pack.device)
    dummy[0, 10:13] = float("inf")
    dummy[0, 13:16] = float("-inf")
    return torch.cat([pack, dummy], dim=0)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def block_anyhit_plain(tri_pack, rays_pack, cid8, early_skip=False,
                       sub_skip=False, stats: Optional[dict] = None):
    """The kernel's function in eager torch ([size, T] bool), with
    block-uniform skips. (The kernel's gates are finer, per warp of 32 lanes
    and over its lanes still open, so it sweeps a subset of these sub-slabs,
    to the same bits.) stats["tests"] counts the ray/triangle tests of the
    (block, cluster or sub-slab) sweeps made over all T lanes,
    stats["lane_tests"] those of the lanes that entered a sweep live and not
    yet occluded (the others need none)."""
    size, _, t_lanes = rays_pack.shape
    s = tri_pack.shape[2]
    dummy = tri_pack.shape[0] - 1
    cid = cid8.reshape(size, GROUP).long()
    occ = torch.zeros((size, t_lanes), dtype=torch.bool, device=rays_pack.device)
    dead = rays_pack[:, 6] < 0.0
    inv = 1.0 / rays_pack[:, 3:6] if sub_skip else None
    tests = 0
    lane_tests = torch.zeros((), dtype=torch.int64, device=occ.device)
    for j in range(GROUP):
        cj = cid[:, j]
        guard = None
        if early_skip:
            guard = (cj < dummy) & ~(occ | dead).all(dim=1)
        for k, (lo, hi) in enumerate(sub_slab_ranges(s, sub_skip)):
            go = guard
            if sub_skip:
                box = tri_pack[cj, 10:16, k]                    # [size, 6]
                pred = sub_pred(box, rays_pack, inv, rays_pack[:, 7],
                                rays_pack[:, 6])
                go = pred if guard is None else pred & guard
            idx = (torch.arange(size, device=occ.device) if go is None
                   else torch.nonzero(go).squeeze(1))
            if idx.numel() == 0:
                continue
            tests += idx.numel() * t_lanes * (hi - lo)
            if stats is not None:
                lane_tests += (~(occ | dead))[idx].sum() * (hi - lo)
            occ[idx] |= sweep_rows_plain(tri_pack, cj[idx], rays_pack[idx],
                                         lo, hi, any_hit=True)
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests
        stats["lane_tests"] = stats.get("lane_tests", 0) + int(lane_tests)
    return occ


def check_fused_inputs(tri_pack, rays_pack, cid8):
    """Shapes, types and index range of one fused-kernel call; raises on
    what the kernels do not take (one host read for the cluster ids).
    Returns (size, s, t_lanes, dummy)."""
    dev = rays_pack.device
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays_pack", rays_pack, torch.float32, 3, dev)
    _check("cid8", cid8, torch.int32, 1, dev)
    c1, rows, s = tri_pack.shape
    size, ray_rows, t_lanes = rays_pack.shape
    if rows != PACK_ROWS or ray_rows != RAY_ROWS or c1 < 2:
        raise ValueError(f"pack shapes {tuple(tri_pack.shape)} / "
                         f"{tuple(rays_pack.shape)} are not [C+1,16,S] / "
                         "[size,8,T]")
    if cid8.shape[0] != size * GROUP:
        raise ValueError(f"cid8 has {cid8.shape[0]} ids, expected "
                         f"{size} x {GROUP}")
    if size:
        lo, hi = torch.stack([cid8.min(), cid8.max()]).tolist()
        sync.note()
        if lo < 0 or hi > c1 - 1:
            raise ValueError(f"cid8 holds cluster ids in [{lo}, {hi}], "
                             f"outside [0, {c1 - 1}]")
    return size, s, t_lanes, c1 - 1


def _kernel():
    fn = cuda_build.load(SOURCE).block_anyhit
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_occupancy(s: int, t_lanes: int) -> dict:
    """Registers per thread and resident warps per SM of block_anyhit's
    (S, T) instance (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).block_anyhit_occupancy,
                          s, t_lanes)


def _kernel_generic():
    fn = cuda_build.load(SOURCE).block_anyhit_generic
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def block_anyhit(tri_pack, rays_pack, cid8, early_skip=False, sub_skip=False):
    """occluded [size, T] bool. CUDA tensors launch the kernel (or raise):
    its tuned instance where one is compiled for (S, T), else its generic
    one; CPU tensors take the plain version."""
    global launches, generic_launches
    dev = rays_pack.device
    if dev.type == "cpu":
        return block_anyhit_plain(tri_pack, rays_pack, cid8, early_skip,
                                  sub_skip)
    if dev.type != "cuda":
        raise ValueError(f"block_anyhit runs on cuda or cpu, not {dev}")
    size, s, t_lanes, dummy = check_fused_inputs(tri_pack, rays_pack, cid8)
    occ = torch.empty((size, t_lanes), dtype=torch.bool, device=dev)
    if size == 0:
        return occ
    err, ran_generic = cuda_build.launch_instance(
        _kernel(), _kernel_generic(), dev,
        (tri_pack.data_ptr(), rays_pack.data_ptr(), cid8.data_ptr(),
         occ.data_ptr(), size, s, t_lanes, dummy, int(early_skip),
         int(sub_skip)))
    if err != 0:
        raise RuntimeError(f"block_anyhit launch failed: cudaError {err}")
    with sync.lock:
        launches += 1
        generic_launches += ran_generic
    return occ


def prepare_fused_wave(accel, origins, directions, t_max, block_size, sort,
                       sort_mode, t_min: float = RAY_TMIN,
                       exact_cull: int = 0):
    """The part both fused cascades share: pad the wave to a power-of-two
    block count >= 32 with dead lanes (o 0, d 1, t_max -1), sort, cull per
    block (exact_cull=K: traverse._exact_block_candidates with super
    shortlist cap K, else the conservative interval cull), and point the
    candidate slots past n_cand at the dummy cluster.
    Returns (origins, directions, t_max, perm, n_cand, entry [nb, c_pad],
    order_g [nb, c_pad / GROUP, GROUP]) over the padded, sorted wave."""
    n0 = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n0,))
    nb = max(32, _next_pow2(-(-n0 // block_size)))
    pad = nb * block_size - n0
    if pad:
        origins = torch.nn.functional.pad(origins, (0, 0, 0, pad))
        directions = torch.nn.functional.pad(directions, (0, 0, 0, pad),
                                             value=1.0)
        t_max = torch.nn.functional.pad(t_max, (0, pad), value=-1.0)
    perm = None
    if sort:
        origins, directions, t_max, perm = traverse._sort_rays(
            accel, origins, directions, t_max, sort_mode)
    o_blk = origins.reshape(nb, block_size, 3)
    d_blk = directions.reshape(nb, block_size, 3)
    tm_blk = t_max.reshape(nb, block_size)
    if exact_cull:
        # a sorted wave is dead-last: its live blocks are a prefix
        order, n_cand, entry = traverse._exact_block_candidates(
            accel, o_blk, d_blk, tm_blk, t_min, ksup=exact_cull,
            live_blocks=traverse.live_block_count(tm_blk) if sort else None)
    else:
        order, n_cand, entry = traverse._block_candidates(accel, o_blk, d_blk,
                                                          tm_blk)
    c = accel.num_clusters
    c_pad = -(-c // GROUP) * GROUP
    if c_pad - c:
        order = torch.nn.functional.pad(order, (0, c_pad - c))
        entry = torch.nn.functional.pad(entry, (0, c_pad - c),
                                        value=float("inf"))
    cols = torch.arange(c_pad, dtype=torch.int32, device=dev)
    order = torch.where(cols[None, :] < n_cand[:, None], order, c)
    return (origins, directions, t_max, perm, n_cand, entry,
            order.reshape(nb, c_pad // GROUP, GROUP))


def any_hit_fused(accel, origins, directions, t_min, t_max,
                  block_size: int = 128, sort_mode: str = "dir",
                  early_skip: bool = False, kernel_chunk: int = 8192,
                  sort: bool = True, sub_skip: bool = False,
                  exact_cull: int = 0, tri_pack=None) -> torch.Tensor:
    """Occlusion query over a wave through the fused cascade ([N] bool).

    Exact per ray; accepts any wave size (pads with dead lanes that sort to
    the end and retire in the first compaction). sort=False skips the
    coherence sort and the unsort; the cull's live-masked bounds keep
    interleaved dead lanes from widening the blocks. Each stage of the
    cascade (traverse._cascade_stages) is one call of
    cuda_cascade.fused_stage: on the card one launch of the stage
    kernel, whose sweep is block_anyhit's body, on the ACTIVE blocks of
    each iteration; on the CPU its plain version, `kernel_chunk` blocks a
    sweep. One host read at the end on the card: the candidate ids' range
    check. tri_pack: pack_tris_dummy(accel), if the caller holds one.
    exact_cull=K: the per-ray-exact cull (prepare_fused_wave), the same
    result."""
    n0 = origins.shape[0]
    origins, directions, t_max, perm, n_cand, _entry, order_g = (
        prepare_fused_wave(accel, origins, directions, t_max, block_size,
                           sort, sort_mode, t_min, exact_cull))
    nb = n_cand.shape[0]
    n = nb * block_size
    if tri_pack is None:
        tri_pack = pack_tris_dummy(accel)
    rays_pack = pack_rays_tiles(origins, directions, t_max, block_size,
                                t_min=float(t_min))
    err = cuda_cascade.new_error(origins.device)

    def stage(blocks, carry, k, threshold):
        rays_pk, nc, ordg = blocks
        return cuda_cascade.fused_stage(
            tri_pack, rays_pk, ordg, nc, carry, k, threshold,
            early_skip=early_skip, sub_skip=sub_skip,
            kernel_chunk=kernel_chunk, err=err)

    carry, blk_index = traverse._cascade_stages(
        (rays_pack, n_cand, order_g),
        (torch.zeros((nb, block_size), dtype=torch.bool,
                     device=origins.device),),
        stage)
    cuda_cascade.raise_bad_ids(err, tri_pack.shape[0] - 1)
    occluded = traverse._unpermute_blocks(carry[0], blk_index).reshape(n)
    return traverse._unsort(occluded, perm)[:n0]
