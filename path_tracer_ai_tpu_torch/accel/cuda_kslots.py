"""The per-ray K-slot sweep of the kslots backend: a hand-written CUDA
kernel and its plain version.

No Pallas kernel stands behind it: it carries the XLA-fused SWEEP and
RESOLVE of the reference's `kslots._chunk_pipeline` (kslots.py:165-185).
Eager torch would gather a [rows, K * S, 3] slab three times and keep
about fifteen [rows, K * S] temporaries (0.6 GB a chunk of 2^15 rays at
K * S = 1,536), so on the card the sweep is one launch of
csrc/kslot_sweep.cu over the query's rays.

`kslot_sweep(tri_pack, rays, cid, n_slots, want_tri)`: ray r tests the S
triangles of each cluster cid[r, k] for k < n_slots[r] within
[t_min, t_max]; a ray with t_max < t_min (dead or overflowed: t_max = -1)
tests nothing. Closest (want_tri) returns (t [N] f32, tri [N] i32): the
minimum t, then the minimum triangle id among the slots at that t (the
oracle's lexicographic rule), or (inf, INT32_MAX); any hit returns
(occluded [N] bool,). Slots whose cid lies outside [0, C) test nothing.
With tie="slot" (closest only) the tri is that of the FIRST slot at the
minimum t, slot k * S + j for triangle j of cluster cid[r, k]
(jnp.argmin's rule), and a miss is (inf, INT32_MAX): the closest sweep of
the perray query, path_tracer_ai_tpu/accel/traverse.py
`closest_hit_perray` (traverse.py:648-665, XLA-fused there). The perray
any-hit query (traverse.py:727-738) is the any-hit sweep as it is. Since
the perray queries' stages run as one launch each of the stage kernel
(accel.cuda_cascade.perray_stage, whose folds sweep with this kernel's
walk of one ray), only their host-stepped comparison loop launches these
two for perray.

On a CUDA tensor the wrapper launches the kernel or raises: its tuned
instances for S in {2, 128}, its generic instance (S at run time, the same
body) for every other S >= 1; K comes from the data. On a CPU tensor it runs `kslot_sweep_plain`, the same arithmetic as eager torch
(cuda_ctiles.mt_sweep_rows), which is used by the tests and the CPU and by
nothing on the card.

Layouts: tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris); rays [N, 8] f32
(ox oy oz dx dy dz t_max t_min, pack_rays); cid [N, K] i32; n_slots [N]
i32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    I32_MAX,
    PACK_ROWS,
    RAY_ROWS,
    _check,
    mt_sweep_rows,
    read_occupancy,
)
from path_tracer_ai_tpu_torch.utils import sync

SOURCE = "kslot_sweep"
INF = float("inf")
PLAIN_ELEMS = 1 << 22  # [rays, K * S] elements per step of the plain version

# Kernel launches since the last reset (the plain version never counts),
# and those of the generic instance and of the first-slot instance
# (tie="slot") among them; updated under sync.lock (the mesh's workers
# launch from several threads).
launches = 0
generic_launches = 0
slot_launches = 0

TIES = ("tri", "slot")
MODE_FIRST = 2  # the kernel's `closest` argument for tie="slot"


def reset_launches() -> None:
    global launches, generic_launches, slot_launches
    with sync.lock:
        launches = generic_launches = slot_launches = 0


def pack_rays(o, d, t_max, t_min) -> torch.Tensor:
    """[N, 8] f32 ray rows: o, d, t_max, t_min."""
    n = o.shape[0]
    tmin = torch.full((n, 1), float(t_min), dtype=torch.float32,
                      device=o.device)
    return torch.cat([o, d, t_max[:, None], tmin], dim=1).contiguous()


def _outputs(n, want_tri, dev):
    if want_tri:
        return (torch.full((n,), INF, dtype=torch.float32, device=dev),
                torch.full((n,), I32_MAX, dtype=torch.int32, device=dev))
    return (torch.zeros((n,), dtype=torch.bool, device=dev),)


def kslot_sweep_plain(tri_pack, rays, cid, n_slots, want_tri: bool,
                      stats: Optional[dict] = None, tie: str = "tri"):
    """The kernel's function in eager torch, the reference's SWEEP and
    RESOLVE, PLAIN_ELEMS [rays, K * S] elements a step; tie="slot": the
    first slot at the minimum t (argmin), the perray sweep's rule, and
    INT32_MAX where that t is inf. stats["tests"]
    counts the tests the data needs: every live slot's S of a closest
    query; for any hit, the slots of the clusters up to and including a
    ray's first occluding one."""
    n, k = cid.shape
    c, _, s = tri_pack.shape
    dev = rays.device
    out = _outputs(n, want_tri, dev)
    step = max(1, PLAIN_ELEMS // (k * s))
    tests = 0
    for a in range(0, n, step):
        b = min(a + step, n)
        cc = cid[a:b].long()
        live = ((torch.arange(k, device=dev)[None, :] < n_slots[a:b, None])
                & (cc >= 0) & (cc < c))
        live = live & (rays[a:b, 6] >= rays[a:b, 7])[:, None]
        tp = tri_pack[torch.clamp(cc, 0, c - 1)]              # [n, K, 10, S]
        tp = tp.transpose(1, 2).reshape(b - a, PACK_ROWS, k * s)
        ray = [rays[a:b, r, None] for r in range(RAY_ROWS)]    # [n, 1]
        tri = [tp[:, r] for r in range(9)]                     # [n, K*S]
        tt, ok = mt_sweep_rows(*ray[:6], *tri, ray[7], ray[6])
        ok = ok & live.repeat_interleave(s, dim=1)
        if not want_tri:
            out[0][a:b] = ok.any(dim=1)
            if stats is not None:
                hit_k = ok.reshape(b - a, k, s).any(dim=2)     # [n, K]
                first = torch.where(hit_k.any(dim=1),
                                    hit_k.to(torch.int8).argmax(dim=1) + 1,
                                    k)
                swept = torch.minimum(first[:, None],
                                      live.sum(dim=1, keepdim=True))
                tests += int(swept.sum()) * s
            continue
        if stats is not None:
            tests += int(live.sum()) * s
        tt = torch.where(ok, tt, INF)
        tid = tp[:, 9].view(torch.int32)
        if tie == "slot":
            slot = torch.argmin(tt, dim=1, keepdim=True)  # the first minimum
            best = torch.gather(tt, 1, slot).squeeze(1)
            out[0][a:b] = best
            out[1][a:b] = torch.where(best < INF, torch.gather(
                tid, 1, slot).squeeze(1), I32_MAX)
            continue
        best = tt.amin(dim=1)
        out[0][a:b] = best
        out[1][a:b] = torch.where(ok & (tt <= best[:, None]), tid,
                                  I32_MAX).amin(dim=1)
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests
    return out


def _kernel():
    fn = cuda_build.load(SOURCE).kslot_sweep
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_generic():
    fn = cuda_build.load(SOURCE).kslot_sweep_generic
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _mode(want_tri: bool, tie: str) -> int:
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, not {tie!r}")
    if tie == "slot" and not want_tri:
        raise ValueError("tie='slot' is a closest-hit rule (want_tri)")
    return MODE_FIRST if tie == "slot" else int(want_tri)


def kernel_occupancy(s: int, want_tri: bool, tie: str = "tri") -> dict:
    """The (S, closest, any-hit or first-slot closest) instance's registers
    and resident warps per SM; S = 0 is the generic instance (needs the
    card)."""
    return read_occupancy(cuda_build.load(SOURCE).kslot_sweep_occupancy, s,
                          _mode(want_tri, tie))


def kslot_sweep(tri_pack, rays, cid, n_slots, want_tri: bool,
                tie: str = "tri"):
    """(t [N] f32, tri [N] i32) or (occluded [N] bool,). CUDA tensors
    launch the kernel (or raise): its tuned instance where one is compiled
    for S, else its generic one; CPU tensors take the plain version."""
    global launches, generic_launches, slot_launches
    mode = _mode(want_tri, tie)
    dev = rays.device
    if dev.type == "cpu":
        return kslot_sweep_plain(tri_pack, rays, cid, n_slots, want_tri,
                                 tie=tie)
    if dev.type != "cuda":
        raise ValueError(f"kslot_sweep runs on cuda or cpu, not {dev}")
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays", rays, torch.float32, 2, dev)
    _check("cid", cid, torch.int32, 2, dev)
    _check("n_slots", n_slots, torch.int32, 1, dev)
    c, rows, s = tri_pack.shape
    n, k = cid.shape
    if rows != PACK_ROWS or rays.shape != (n, RAY_ROWS):
        raise ValueError(f"pack shapes {tuple(tri_pack.shape)} / "
                         f"{tuple(rays.shape)} are not [C,10,S] / [{n},8]")
    if n_slots.shape[0] != n or k < 1 or s < 1:
        raise ValueError(f"cid {tuple(cid.shape)} and n_slots "
                         f"{tuple(n_slots.shape)} need one row a ray, K >= 1 "
                         f"(and S >= 1, not {s})")
    out = _outputs(n, want_tri, dev)
    if n == 0:
        return out
    t_out = out[0]
    tri_out = out[1] if want_tri else out[0]
    err, ran_generic = cuda_build.launch_instance(
        _kernel(), _kernel_generic(), dev,
        (tri_pack.data_ptr(), rays.data_ptr(), cid.data_ptr(),
         n_slots.data_ptr(), t_out.data_ptr(), tri_out.data_ptr(), n, k, s,
         c, mode))
    if err != 0:
        raise RuntimeError(f"kslot_sweep launch failed: cudaError {err}")
    with sync.lock:
        launches += 1
        generic_launches += ran_generic
        slot_launches += mode == MODE_FIRST
    return out
