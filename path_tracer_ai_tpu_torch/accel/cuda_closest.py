"""The fused closest-hit cascade.

Counterpart of path_tracer_ai_tpu/accel/pallas_closest.py, the closest-hit
twin of accel.cuda_anyhit: the packet cascade's structure (coherence sort,
conservative interval cull, entry-ordered iterations with block retirement
and compaction) with GROUP = 8 candidate clusters swept per block and
iteration; on the card each stage of its loop is one launch of the fused
stage kernel (accel.cuda_cascade.fused_stage), whose sweep is the body of
block_closest's generic instance. Between iterations each lane's t_max
shrinks to its best so far, and a block retires once the next group's
conservative entry exceeds every live lane's best. `block_closest`
replaces the Pallas kernel of the same name: on a CUDA tensor it launches
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
from path_tracer_ai_tpu_torch.accel import cuda_cascade, traverse
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
    sub_slab_ranges,
    sweep_rows_plain,
)
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "fused_closest"
# The sub_skip gate grows a sub-slab's box by this much of the largest
# coordinate magnitude of the ray's origin and the box (csrc/mt.cuh, where
# the bound it covers is derived, defines it: gate_lanes).
GATE_PAD = cuda_build.header_float("GATE_PAD")

# Kernel launches since the last reset (the plain version never counts),
# and those of the generic instance among them; updated under sync.lock
# (the mesh's workers launch from several threads).
launches = 0
generic_launches = 0


def reset_launches() -> None:
    global launches, generic_launches
    with sync.lock:
        launches = generic_launches = 0


def gate_lanes(box, rays, inv, t_lo, t_hi) -> torch.Tensor:
    """[n, T] bool: the closest sweeps' sub_skip gate of each lane
    (csrc/mt.cuh gate_lane, the same bits): does the lane's [t_lo, t_hi]
    segment touch the sub-slab's box grown by GATE_PAD x (max |o| + max
    |box|, over its finite coordinates) on every side? box [n, 6] lo.xyz
    hi.xyz, rays [n, 8, T], inv [n, 3, T] = 1/d, t_lo / t_hi [n, T]. The
    maxima and the slab are in comparison-select form: a NaN keeps the
    running value. Dead lanes (t_hi < 0) fail."""
    def sel_max(a, b):
        return torch.where(b > a, b, a)

    o = rays[:, :3].abs()
    om = sel_max(sel_max(o[:, 0], o[:, 1]), o[:, 2])            # [n, T]
    # the finite coordinates: an empty sub-slab's box is inverted (+-inf)
    b = box.abs()
    bm = torch.zeros_like(b[:, 0])
    for i in range(6):
        bm = torch.where((b[:, i] > bm) & (b[:, i] < INF), b[:, i], bm)
    pad = (om + bm[:, None]) * GATE_PAD                         # [n, T]
    lo, hi = t_lo, t_hi
    for axis in range(3):
        o_row, inv_row = rays[:, axis], inv[:, axis]
        t0 = (box[:, axis, None] - pad - o_row) * inv_row
        t1 = (box[:, 3 + axis, None] + pad - o_row) * inv_row
        neg = inv_row < 0.0
        near, far = torch.where(neg, t1, t0), torch.where(neg, t0, t1)
        lo = torch.where(near > lo, near, lo)
        hi = torch.where(far < hi, far, hi)
    return hi >= lo


def block_closest_plain(tri_pack, rays_pack, cid8, sub_skip=True,
                        stats: Optional[dict] = None):
    """The kernel's function in eager torch -> (t [size, T] f32, tri
    [size, T] i32), with block-uniform skips: the dummy cluster always, and
    under sub_skip every sub-slab that no lane's gate passes (gate_lanes:
    its [t_min, min(t_max, running best)] segment against the sub-slab's
    grown box). A lane takes a swept sub-slab's hits only where its own
    gate passes, so the kernel, which votes per warp of 32 lanes and sweeps
    a subset of these sub-slabs, gives the same bits.
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
            touch = None
            if sub_skip:
                touch = gate_lanes(tri_pack[cj, 10:16, k], rays_pack, inv,
                                   rays_pack[:, 7], cap)
                go = guard & touch.any(dim=1)
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                continue
            tests += idx.numel() * t_lanes * (hi - lo)
            if stats is not None:
                lane_tests += live_per_block[idx].sum() * (hi - lo)
            cap_i = cap[idx]
            if touch is not None:
                # a lane whose own gate fails sweeps with its window closed
                cap_i = torch.where(touch[idx], cap_i, -INF)
            kt, ktri = sweep_rows_plain(tri_pack, cj[idx], rays_pack[idx],
                                        lo, hi, t_max=cap_i)
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
    count with dead lanes). Each stage of the cascade is one call of
    cuda_cascade.fused_stage (traverse._cascade_stages): on the card one
    launch of the stage kernel, whose sweep is block_closest's body, on
    every block with candidates left in each iteration (the JAX package's
    sweep set); on the CPU its plain version, `kernel_chunk` blocks a
    sweep. One host read at the end on the card: the candidate ids' range
    check. tri_pack: pack_tris_dummy(accel), if the caller holds one.
    exact_cull=K: the per-ray-exact cull
    (cuda_anyhit.prepare_fused_wave); its candidates keep the conservative
    entry order, so the front-to-back stop still holds, and the result is
    the same."""
    n0 = origins.shape[0]
    dev = origins.device
    origins, directions, t_max, perm, n_cand, entry, order_g = (
        prepare_fused_wave(accel, origins, directions, t_max, block_size,
                           sort, sort_mode, t_min, exact_cull))
    nb = n_cand.shape[0]
    n = nb * block_size
    if tri_pack is None:
        tri_pack = pack_tris_dummy(accel)
    rays_pack = pack_rays_tiles(origins, directions, t_max, block_size,
                                t_min=float(t_min))
    err = cuda_cascade.new_error(dev)

    def stage(blocks, carry, k, threshold):
        rays_pk, nc, ent, ordg = blocks
        return cuda_cascade.fused_stage(
            tri_pack, rays_pk, ordg, nc, carry, k, threshold, entry=ent,
            sub_skip=sub_skip, kernel_chunk=kernel_chunk, err=err)

    carry, blk_index = traverse._cascade_stages(
        (rays_pack, n_cand, entry, order_g),
        (torch.full((nb, block_size), INF, dtype=torch.float32, device=dev),
         torch.full((nb, block_size), I32_MAX, dtype=torch.int32, device=dev)),
        stage)
    cuda_cascade.raise_bad_ids(err, tri_pack.shape[0] - 1)
    best_t, best_id = (
        traverse._unsort(traverse._unpermute_blocks(a, blk_index).reshape(n),
                         perm)[:n0] for a in carry)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t, tri=torch.where(hit, best_id, -1))
