"""The `pallas` backend: per-block candidate walks inside one kernel.

Counterpart of path_tracer_ai_tpu/accel/pallas_sweep.py. The wave is sorted
and culled per block as in the packet cascade (traverse._sort_keys,
traverse._block_candidates); then ONE kernel launch per wave lets every
block of rays walk its own candidate list front to back, with no host read
in between. `closest_sweep` / `anyhit_sweep` replace the Pallas kernels
`closest_sweep_pallas` / `anyhit_sweep_pallas`; on a CUDA tensor they launch
csrc/packet_sweep.cu (or raise), on a CPU tensor they run
`closest_sweep_plain` / `anyhit_sweep_plain`, the same function as eager
torch ops. The kernels' design and bound are described in the CUDA source.
Both have tuned instances for S in {64, 128, 256} and a generic instance
for every other S >= 1 (the same bits); R is a runtime argument in
(0, 1024] (ValueError outside it).

Tie rule: a candidate replaces the best only with t < best, so on an exact
tie the first slot of the first candidate wins; the other backends keep
the oracle's minimum triangle id. Occlusion has no ties.

Layouts:
  slab.tri [C, 9, S] f32 (build_slab_table): v0.xyz, e1.xyz, e2.xyz rows.
  rays     [B, 8, R] f32: ox oy oz dx dy dz t_cap, row 7 unused; t_cap < 0
           marks a dead lane.
  order    [B, C_pad] i32 / entry [B, C_pad] f32 / n_cand [B] i32: the
           block's candidate clusters by ascending conservative entry.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel import traverse
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    PLAIN_ELEMS,
    RAY_ROWS,
    _check,
    mt_sweep_rows,
    read_occupancy,
)
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "packet_sweep"
SLAB_ROWS = 9
TABLE_PAD = 128  # candidate tables are padded to a multiple of this width

# Kernel launches since the last reset (the plain versions never count),
# and those of the generic instances among them; updated under sync.lock
# (the mesh's workers launch from several threads).
launches = {"closest_sweep": 0, "anyhit_sweep": 0}
generic_launches = {"closest_sweep": 0, "anyhit_sweep": 0}


def reset_launches() -> None:
    with sync.lock:
        for name in launches:
            launches[name] = generic_launches[name] = 0


def _count(name: str, ran_generic: bool) -> None:
    with sync.lock:
        launches[name] += 1
        generic_launches[name] += ran_generic


class SlabTable(NamedTuple):
    """Triangle data in the sweep kernels' layout."""

    tri: torch.Tensor     # [C, 9, S] f32: v0xyz, e1xyz, e2xyz rows
    tri_id: torch.Tensor  # [C, S] i32 global ids (-1 padding)


def build_slab_table(accel: ClusterAccel) -> SlabTable:
    rows = [a.transpose(1, 2) for a in (accel.v0, accel.e1, accel.e2)]
    return SlabTable(tri=torch.cat(rows, dim=1).contiguous(),
                     tri_id=accel.tri_id)


def _visit(slab, rays, cid, t_min, idx):
    """Blocks idx of `rays` against cluster cid[i] each -> (t [n, R, S], inf
    where the test fails; ok [n, R, S])."""
    tp = slab.tri[cid]                                     # [n, 9, S]
    rp = rays[idx]
    ray = [rp[:, k, :, None] for k in range(RAY_ROWS)]     # [n, R, 1]
    tri = [tp[:, k, None, :] for k in range(SLAB_ROWS)]    # [n, 1, S]
    return mt_sweep_rows(*ray[:6], *tri, t_min, ray[6])


def _plain_step(rays, s) -> int:
    return max(1, PLAIN_ELEMS // (rays.shape[2] * s))


def _add_stats(stats: dict, visits: int, lanes, s: int) -> None:
    stats["visits"] = stats.get("visits", 0) + visits
    stats["lane_tests"] = stats.get("lane_tests", 0) + int(lanes) * s


def closest_sweep_plain(slab, rays, order, entry, n_cand, t_min=1e-3,
                        stats: Optional[dict] = None):
    """The closest kernel's function in eager torch: a loop over candidate
    position k with a per-block "still walking" mask that follows the
    kernel's exit rule. stats["visits"] counts the (block, cluster) pairs
    swept, stats["lane_tests"] the ray/triangle tests of their live lanes
    (a dead lane fails every test on t <= t_cap and needs none)."""
    b, _, r = rays.shape
    s = slab.tri.shape[2]
    dev = rays.device
    best_t = torch.full((b, r), INF, dtype=torch.float32, device=dev)
    best_cid = torch.full((b, r), -1, dtype=torch.int32, device=dev)
    best_slot = torch.zeros((b, r), dtype=torch.int32, device=dev)
    dead = rays[:, 6] < 0.0
    walking = torch.ones((b,), dtype=torch.bool, device=dev)
    step = _plain_step(rays, s)
    visits = 0
    live_lanes = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(order.shape[1]):
        best_max = torch.where(dead, -INF, best_t).amax(dim=1)
        walking = walking & (k < n_cand) & (entry[:, k] <= best_max)
        act = torch.nonzero(walking).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        if stats is not None:
            live_lanes += (~dead[act]).sum()
        for a in range(0, act.numel(), step):
            idx = act[a:a + step]
            cid = order[idx, k]
            tt, _ok = _visit(slab, rays, cid.long(), t_min, idx)
            tt = torch.where(tt < best_t[idx][:, :, None], tt, INF)
            ct = tt.amin(dim=-1)
            slot = tt.argmin(dim=-1).to(torch.int32)       # first minimum
            closer = ct < best_t[idx]
            best_cid[idx] = torch.where(closer, cid[:, None], best_cid[idx])
            best_slot[idx] = torch.where(closer, slot, best_slot[idx])
            best_t[idx] = torch.where(closer, ct, best_t[idx])
    if stats is not None:
        _add_stats(stats, visits, live_lanes, s)
    return best_t, best_cid, best_slot


def anyhit_sweep_plain(slab, rays, order, n_cand, t_min=1e-3,
                       stats: Optional[dict] = None):
    """The any-hit kernel's function in eager torch ([B, R] bool). A block
    walks on while some lane is neither occluded nor dead (t_cap < t_min: it
    can pass no test); the kernel's walk is per warp of 32 lanes, so it
    makes at most these visits. stats["visits"] counts the (block, cluster)
    pairs swept, stats["lane_tests"] the tests of the lanes that entered a
    visit open (the others need none)."""
    b, _, r = rays.shape
    s = slab.tri.shape[2]
    dev = rays.device
    occ = torch.zeros((b, r), dtype=torch.bool, device=dev)
    dead = ~(rays[:, 6] >= t_min)
    step = _plain_step(rays, s)
    visits = 0
    open_lanes = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(order.shape[1]):
        act = torch.nonzero((k < n_cand) & ~(occ | dead).all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        if stats is not None:
            open_lanes += (~(occ[act] | dead[act])).sum()
        for a in range(0, act.numel(), step):
            idx = act[a:a + step]
            _tt, ok = _visit(slab, rays, order[idx, k].long(), t_min, idx)
            occ[idx] |= ok.any(dim=-1)
    if stats is not None:
        _add_stats(stats, visits, open_lanes, s)
    return occ


def _kernel(name, n_ptr, n_int):
    fn = getattr(cuda_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tables(slab, rays, order, n_cand, entry=None):
    """Shapes, types and index ranges of one sweep call; raises on what the
    kernels do not take. One host read for the index ranges."""
    dev = rays.device
    _check("slab.tri", slab.tri, torch.float32, 3, dev)
    _check("rays", rays, torch.float32, 3, dev)
    _check("order", order, torch.int32, 2, dev)
    _check("n_cand", n_cand, torch.int32, 1, dev)
    c, rows, s = slab.tri.shape
    b, ray_rows, r = rays.shape
    if rows != SLAB_ROWS or ray_rows != RAY_ROWS:
        raise ValueError(f"shapes {tuple(slab.tri.shape)} / {tuple(rays.shape)}"
                         " are not [C,9,S] / [B,8,R]")
    if order.shape[0] != b or n_cand.shape[0] != b:
        raise ValueError(f"order {tuple(order.shape)} / n_cand "
                         f"{tuple(n_cand.shape)} do not cover {b} blocks")
    if entry is not None:
        _check("entry", entry, torch.float32, 2, dev)
        if entry.shape != order.shape:
            raise ValueError(f"entry {tuple(entry.shape)} != order "
                             f"{tuple(order.shape)}")
    if not 0 < r <= 1024:
        raise ValueError(f"R = {r} lanes per block is outside (0, 1024]")
    if b:
        lo, hi, n_lo, n_hi = torch.stack(
            [order.min(), order.max(), n_cand.min(), n_cand.max()]).tolist()
        sync.note()
        if lo < 0 or hi >= c:
            raise ValueError(f"order holds cluster ids in [{lo}, {hi}], "
                             f"outside [0, {c})")
        if n_lo < 0 or n_hi > order.shape[1]:
            raise ValueError(f"n_cand in [{n_lo}, {n_hi}] is outside "
                             f"[0, {order.shape[1]}]")
    return b, s, r


def closest_sweep(slab: SlabTable, rays, order, entry, n_cand, t_min=1e-3):
    """(best_t [B, R] f32 inf = miss, best_cid [B, R] i32 -1 = none,
    best_slot [B, R] i32). CUDA tensors launch the kernel (or raise): its
    tuned instance where one is compiled for S, else its generic one; CPU
    tensors take the plain version."""
    dev = rays.device
    if dev.type == "cpu":
        return closest_sweep_plain(slab, rays, order, entry, n_cand, t_min)
    if dev.type != "cuda":
        raise ValueError(f"closest_sweep runs on cuda or cpu, not {dev}")
    b, s, r = _check_tables(slab, rays, order, n_cand, entry)
    best_t = torch.empty((b, r), dtype=torch.float32, device=dev)
    best_cid = torch.empty((b, r), dtype=torch.int32, device=dev)
    best_slot = torch.empty((b, r), dtype=torch.int32, device=dev)
    if b == 0:
        return best_t, best_cid, best_slot
    # Blocks start longest list first: a wave's time is at least its
    # longest walk's, and a long walk started last would add to it.
    block_order = torch.argsort(n_cand, descending=True, stable=True).to(
        torch.int32)
    err, ran_generic = cuda_build.launch_instance(
        _kernel("closest_sweep", 9, 4),
        _kernel("closest_sweep_generic", 9, 4), dev,
        (slab.tri.data_ptr(), rays.data_ptr(), order.data_ptr(),
         entry.data_ptr(), n_cand.data_ptr(), block_order.data_ptr(),
         best_t.data_ptr(), best_cid.data_ptr(), best_slot.data_ptr(), b, s,
         r, order.shape[1], float(t_min)))
    if err != 0:
        raise RuntimeError(f"closest_sweep launch failed: cudaError {err}")
    _count("closest_sweep", ran_generic)
    return best_t, best_cid, best_slot


def closest_occupancy(s: int, r_lanes: int) -> dict:
    """Registers per thread and resident warps per SM of the closest_sweep
    instance that serves (S, R) (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).closest_sweep_occupancy, s,
                          r_lanes)


def anyhit_occupancy(s: int) -> dict:
    """Registers per thread and resident warps per SM of anyhit_sweep's S
    instance (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).anyhit_sweep_occupancy, s)


def anyhit_sweep(slab: SlabTable, rays, order, n_cand, t_min=1e-3):
    """occluded [B, R] bool. CUDA tensors launch the kernel (or raise): its
    tuned instance where one is compiled for S, else its generic one; CPU
    tensors take the plain version."""
    dev = rays.device
    if dev.type == "cpu":
        return anyhit_sweep_plain(slab, rays, order, n_cand, t_min)
    if dev.type != "cuda":
        raise ValueError(f"anyhit_sweep runs on cuda or cpu, not {dev}")
    b, s, r = _check_tables(slab, rays, order, n_cand)
    occ = torch.empty((b, r), dtype=torch.bool, device=dev)
    if b == 0:
        return occ
    err, ran_generic = cuda_build.launch_instance(
        _kernel("anyhit_sweep", 5, 4), _kernel("anyhit_sweep_generic", 5, 4),
        dev, (slab.tri.data_ptr(), rays.data_ptr(), order.data_ptr(),
              n_cand.data_ptr(), occ.data_ptr(), b, s, r, order.shape[1],
              float(t_min)))
    if err != 0:
        raise RuntimeError(f"anyhit_sweep launch failed: cudaError {err}")
    _count("anyhit_sweep", ran_generic)
    return occ


def _prep_wave(accel, origins, directions, t_max, block_size, sort,
               with_entry: bool = True):
    """Sort ("dir" keys), block and cull one wave -> (rays [B, 8, R], order,
    entry, n_cand, perm); the tables are padded to a multiple of 128 columns
    (order with 0, entry with inf). entry is None where with_entry is
    False."""
    n = origins.shape[0]
    if n % block_size:
        raise ValueError(f"wave size {n} not a multiple of {block_size}")
    nb = n // block_size
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    perm = None
    if sort:
        origins, directions, t_max, perm = traverse._sort_rays(
            accel, origins, directions, t_max, "dir")
    o_blk = origins.reshape(nb, block_size, 3)
    d_blk = directions.reshape(nb, block_size, 3)
    tb = t_max.reshape(nb, block_size)
    order, n_cand, entry = traverse._block_candidates(
        accel, o_blk, d_blk, tb, with_entry=with_entry)
    pad = (-order.shape[1]) % TABLE_PAD
    if pad:
        order = torch.nn.functional.pad(order, (0, pad))
        if with_entry:
            entry = torch.nn.functional.pad(entry, (0, pad), value=INF)
    rays = traverse.pack_block_rays(o_blk, d_blk, tb, 0.0)
    return (rays, order.contiguous(),
            entry.contiguous() if with_entry else None, n_cand, perm)


def closest_hit_pallas(accel: ClusterAccel, slab: SlabTable, origins,
                       directions, t_min, t_max, block_size: int = 128,
                       sort: bool = True) -> PacketHit:
    """Closest hit over a wave on the `pallas` backend; the wave size must
    be a multiple of block_size."""
    n = origins.shape[0]
    rays, order, entry, n_cand, perm = _prep_wave(
        accel, origins, directions, t_max, block_size, sort)
    best_t, best_cid, best_slot = closest_sweep(
        slab, rays, order, entry, n_cand, t_min=float(t_min))
    gid = slab.tri_id[torch.clamp(best_cid, min=0).long(), best_slot.long()]
    gid = torch.where(best_cid >= 0, gid, -1)
    t_out = traverse._unsort(best_t.reshape(n), perm)
    return PacketHit(hit=torch.isfinite(t_out), t=t_out,
                     tri=traverse._unsort(gid.reshape(n), perm))


def any_hit_pallas(accel: ClusterAccel, slab: SlabTable, origins, directions,
                   t_min, t_max, block_size: int = 128,
                   sort: bool = True) -> torch.Tensor:
    """Occlusion over a wave on the `pallas` backend ([N] bool)."""
    n = origins.shape[0]
    rays, order, _entry, n_cand, perm = _prep_wave(
        accel, origins, directions, t_max, block_size, sort,
        with_entry=False)
    occ = anyhit_sweep(slab, rays, order, n_cand, t_min=float(t_min))
    return traverse._unsort(occ.reshape(n), perm)
