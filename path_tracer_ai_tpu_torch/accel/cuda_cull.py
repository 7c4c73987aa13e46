"""The packet cascades' interval cull: a hand-written CUDA kernel and its
plain version.

Replaces no Pallas kernel: it carries the XLA-fused body of the JAX
package's `_block_candidates` (path_tracer_ai_tpu/accel/traverse.py:
171-202), the conservative cull of every block of R rays against every
cluster box, which JAX runs as one fusion feeding one sort. Per block:
the live lanes' origin and direction bounds, the interval slab test
against each cluster (accel.traverse._interval_slab, op for op), the
candidate mask, each cluster's conservative entry (max(lb, 0), +inf past
the candidates) and the stable ascending sort of the entries.

`block_candidates(accel, o_blk, d_blk, tm_blk, with_entry=True)` is the
kernel's wrapper: CUDA tensors only; it launches csrc/packet_cull.cu (built
with nvcc at first use, see cuda_build) or raises, and never runs the
plain version. `block_candidates_plain` is that plain version, eager torch
in row chunks, which the CPU takes (accel.traverse._block_candidates
dispatches on the device). Both return (order [nb, C] i32, n_cand [nb]
i32, entry_sorted [nb, C] f32, or None where with_entry is False: callers
that do not read the entries save its writes). The two agree bit for bit
on order and n_cand, and on entry_sorted as values (-0.0 == +0.0).

Layouts: o_blk, d_blk [nb, R, 3] f32, tm_blk [nb, R] f32 (t_max; negative:
a dead lane), all contiguous; accel.bmin, accel.bmax [C, 3] f32. Any R >= 1
and C >= 1: past C = 16,384 (SMEM_SORT_MAX_C) a thread block sorts in a
device-memory scratch buffer that the wrapper allocates.
"""

from __future__ import annotations

import ctypes

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "packet_cull"
# the largest C whose sort fits one thread block's shared memory
# (8 * pow2(C) + 4 * C bytes; csrc/packet_cull.cu SMEM_LIMIT)
SMEM_SORT_MAX_C = 16384

# Kernel launches since the last reset (the plain version counts nothing);
# updated under sync.lock (the mesh's workers launch from several threads).
launches = 0


def reset_launches() -> None:
    global launches
    with sync.lock:
        launches = 0


def block_candidates_plain(accel, o_blk, d_blk, t_max_blk,
                           with_entry: bool = True, row_chunk: int = 8192):
    """The cull in eager torch, `row_chunk` blocks at a time so that the
    [rows, C] temporaries stay small: (order [nb, C] i32 cluster ids by
    ascending conservative entry, candidates first; n_cand [nb] i32;
    entry_sorted [nb, C] f32, or None where with_entry is False)."""
    from path_tracer_ai_tpu_torch.accel import traverse

    orders, ncands, entries = [], [], []
    for lo in range(0, o_blk.shape[0], row_chunk):
        ob = o_blk[lo:lo + row_chunk]
        db = d_blk[lo:lo + row_chunk]
        tb = t_max_blk[lo:lo + row_chunk]
        lb, ub = traverse._block_interval_bounds(accel, ob, db,
                                                 live=tb >= 0.0)
        tmax_ub = tb.amax(dim=1)
        cand = (lb <= ub) & (ub >= 0.0) & (lb <= tmax_ub[:, None])
        entry = torch.where(cand, torch.clamp(lb, min=0.0), INF)
        order = torch.argsort(entry, dim=1, stable=True)
        orders.append(order.to(torch.int32))
        if with_entry:
            entries.append(torch.gather(entry, 1, order))
        ncands.append(cand.sum(dim=1).to(torch.int32))
    return (torch.cat(orders), torch.cat(ncands),
            torch.cat(entries) if with_entry else None)


def _check(tensors):
    """Type, rank and layout of every (name, tensor, ndim) first, then the
    device, so that each check can be shown to fire on the CPU."""
    for name, x, ndim in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
        if x.dim() != ndim:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{ndim} dims")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _ndim in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}: block_candidates "
                             f"launches the CUDA kernel (the CPU takes "
                             f"block_candidates_plain)")


def _lib():
    lib = cuda_build.load(SOURCE)
    fn = lib.packet_cull
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.packet_cull_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.packet_cull_scratch_bytes.restype = ctypes.c_longlong
    return lib


def occupancy(c: int) -> dict:
    """The kernel's registers and resident warps per SM at C clusters
    (needs the card)."""
    from path_tracer_ai_tpu_torch.accel.cuda_ctiles import read_occupancy

    return read_occupancy(cuda_build.load(SOURCE).packet_cull_occupancy, c)


def block_candidates(accel, o_blk, d_blk, tm_blk, with_entry: bool = True):
    """The cull on the card, one launch: (order [nb, C] i32, n_cand [nb]
    i32, entry_sorted [nb, C] f32 or None), as block_candidates_plain.
    Raises on a tensor that is not a contiguous f32 CUDA tensor of the
    layout above, and where the launch fails."""
    global launches
    _check((("o_blk", o_blk, 3), ("d_blk", d_blk, 3), ("tm_blk", tm_blk, 2),
            ("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2)))
    nb, r = o_blk.shape[:2]
    c = accel.num_clusters
    dev = o_blk.device
    if (o_blk.shape[2] != 3 or d_blk.shape != o_blk.shape
            or tuple(tm_blk.shape) != (nb, r)
            or tuple(accel.bmin.shape) != (c, 3)
            or accel.bmax.shape != accel.bmin.shape):
        raise ValueError("block_candidates takes o_blk / d_blk [nb, R, 3], "
                         "tm_blk [nb, R] and boxes [C, 3]")
    if any(x.device != dev for x in (d_blk, tm_blk, accel.bmin,
                                     accel.bmax)):
        raise ValueError("block_candidates takes every tensor on one card")
    if r < 1 or c < 1:
        raise ValueError(f"block_candidates takes R >= 1 and C >= 1, not "
                         f"R = {r}, C = {c}")
    order = torch.empty((nb, c), dtype=torch.int32, device=dev)
    n_cand = torch.empty((nb,), dtype=torch.int32, device=dev)
    entry = (torch.empty((nb, c), dtype=torch.float32, device=dev)
             if with_entry else None)
    if nb == 0:
        return order, n_cand, entry
    lib = _lib()
    nscratch = lib.packet_cull_scratch_bytes(nb, c)
    scratch = (torch.empty((nscratch,), dtype=torch.uint8, device=dev)
               if nscratch else None)
    err = cuda_build.launch(
        lib.packet_cull, dev, o_blk.data_ptr(), d_blk.data_ptr(),
        tm_blk.data_ptr(), accel.bmin.data_ptr(), accel.bmax.data_ptr(),
        nb, r, c, order.data_ptr(), n_cand.data_ptr(),
        None if entry is None else entry.data_ptr(),
        None if scratch is None else scratch.data_ptr())
    if err != 0:
        raise RuntimeError(f"packet_cull launch failed: cudaError {err}")
    with sync.lock:
        launches += 1
    return order, n_cand, entry
