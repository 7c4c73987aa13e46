"""The work-item sweep of the worklist backend: a hand-written CUDA kernel
and its plain version.

No Pallas kernel stands behind it: it carries the body of the reference's
XLA-fused `worklist._sweep_items` (worklist.py:325-422), the
`intersector="exact"` form. A work item is (block, group index k): the
block's B rays against the g candidate clusters order_g[block, k] of S
triangles each. Eager torch would loop over chunks of items on the host
and materialise [items, B, g * S] temporaries, so on the card the sweep is
one launch of csrc/item_sweep.cu over all real items.

`item_sweep(tri_pack, rays, item_block, ibase, order_g, n_cand, n_items,
want_tri)` returns, per item row of [i_cap, B]:
- closest (want_tri): t = the minimum t of the slots that pass, tri = the
  minimum triangle id among the slots at that t (inf / INT32_MAX when none
  passes);
- any hit: whether some slot passes.
A slot passes when its cluster slot k * g + j is below the block's n_cand
and Möller–Trumbore (traverse._mt_sweep's op order) hits within
[t_min, t_max]. Rows from n_items on hold (inf, INT32_MAX) or False.
n_items is the real item count, as a 0-dim i32 tensor on the rays' device
(the kernel reads it there: the worklist's route reads no host value for
it, as the reference's fori_loop to the traced count) or a Python int;
it is clamped to [0, i_cap].

On a CUDA tensor the wrapper launches the kernel or raises: its tuned
instances for S in {2, 128}, its generic instance (S at run time, the same
bits) for every other S >= 1; the kernel takes B = 8 rays a block and g = 4
clusters an item only (ValueError for another B or g). On a CPU tensor it
runs `item_sweep_plain`, the same arithmetic as eager torch ops, which
is used by the tests and the CPU and by nothing on the card.

Layouts: tri_pack [C, 10, S] f32 (cuda_ctiles.pack_tris); rays [nb, 8, B]
f32 (traverse.pack_block_rays: ox oy oz dx dy dz t_max t_min); item_block
[i_cap] i32; ibase, n_cand [nb] i32; order_g [nb, n_groups, g] i32.
"""

from __future__ import annotations

import ctypes

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

SOURCE = "item_sweep"
INF = float("inf")
BLOCK, GROUP = 8, 4  # B rays a block, g clusters an item: one lane each pair
PLAIN_ELEMS = 1 << 22  # [items, B, g * S] elements per step of the plain version

# Kernel launches since the last reset (the plain version never counts),
# and those of the generic instance among them; updated under sync.lock
# (the mesh's workers launch from several threads).
launches = 0
generic_launches = 0


def reset_launches() -> None:
    global launches, generic_launches
    with sync.lock:
        launches = generic_launches = 0


def _outputs(i_cap, b, want_tri, dev):
    if want_tri:
        return (torch.full((i_cap, b), INF, dtype=torch.float32, device=dev),
                torch.full((i_cap, b), I32_MAX, dtype=torch.int32,
                           device=dev))
    return (torch.zeros((i_cap, b), dtype=torch.bool, device=dev),)


def item_sweep_plain(tri_pack, rays, item_block, ibase, order_g, n_cand,
                     n_items, want_tri: bool):
    """The kernel's function in eager torch, the reference's `_sweep_items`
    body, PLAIN_ELEMS [items, B, g * S] elements a step. n_items: an int
    or a 0-dim tensor (read here: the CPU's, or a comparison's on the
    card)."""
    nb, _, b = rays.shape
    n_groups, g = order_g.shape[1:]
    s = tri_pack.shape[2]
    dev = rays.device
    i_cap = item_block.shape[0]
    n_items = min(max(int(n_items), 0), i_cap)
    out = _outputs(i_cap, b, want_tri, dev)
    step = max(1, PLAIN_ELEMS // (b * g * s))
    for a in range(0, n_items, step):
        j = torch.arange(a, min(a + step, n_items), device=dev)
        blk = item_block[j].long()
        k = torch.clamp(j - ibase[blk].long(), 0, n_groups - 1)
        cid = order_g[blk, k].long()                              # [n, g]
        slot_live = (k[:, None] * g + torch.arange(g, device=dev)[None, :]
                     < n_cand[blk][:, None])                      # [n, g]
        tp = tri_pack[cid].transpose(1, 2).reshape(j.shape[0], PACK_ROWS, -1)
        rp = rays[blk]                                            # [n, 8, B]
        ray = [rp[:, r, :, None] for r in range(RAY_ROWS)]
        tri = [tp[:, r, None, :] for r in range(9)]
        tt, ok = mt_sweep_rows(*ray[:6], *tri, ray[7], ray[6])
        ok = ok & slot_live.repeat_interleave(s, dim=1)[:, None, :]
        if not want_tri:
            out[0][a:a + j.shape[0]] = ok.any(dim=-1)
            continue
        tt = torch.where(ok, tt, INF)
        ct = tt.amin(dim=-1)
        tid = tp[:, 9, None, :].view(torch.int32)
        out[0][a:a + j.shape[0]] = ct
        out[1][a:a + j.shape[0]] = torch.where(
            ok & (tt <= ct[..., None]), tid, I32_MAX).amin(dim=-1)
    return out


def _entry(name):
    fn = getattr(cuda_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def kernel_occupancy(s: int, want_tri: bool) -> dict:
    """The (S, closest or any-hit) instance's registers and resident warps
    per SM; S = 0 is the generic instance (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).item_sweep_occupancy, s,
                          int(want_tri))


def item_sweep(tri_pack, rays, item_block, ibase, order_g, n_cand,
               n_items, want_tri: bool):
    """(t [i_cap, B] f32, tri [i_cap, B] i32) or (occluded [i_cap, B] bool,)
    over items [0, n_items). CUDA tensors launch the kernel (or raise): its
    tuned instance where one is compiled for S, else its generic one; it
    reads a tensor n_items on the card (an int one is checked here, and
    copied there; 0 launches nothing). CPU tensors take the plain
    version."""
    global launches, generic_launches
    dev = rays.device
    if dev.type == "cpu":
        return item_sweep_plain(tri_pack, rays, item_block, ibase, order_g,
                                n_cand, n_items, want_tri)
    if dev.type != "cuda":
        raise ValueError(f"item_sweep runs on cuda or cpu, not {dev}")
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays", rays, torch.float32, 3, dev)
    _check("item_block", item_block, torch.int32, 1, dev)
    _check("ibase", ibase, torch.int32, 1, dev)
    _check("order_g", order_g, torch.int32, 3, dev)
    _check("n_cand", n_cand, torch.int32, 1, dev)
    c, rows, s = tri_pack.shape
    nb, ray_rows, b = rays.shape
    n_groups, g = order_g.shape[1:]
    if rows != PACK_ROWS or ray_rows != RAY_ROWS:
        raise ValueError(f"pack shapes {tuple(tri_pack.shape)} / "
                         f"{tuple(rays.shape)} are not [C,10,S] / [nb,8,B]")
    if (b, g) != (BLOCK, GROUP) or s < 1:
        raise ValueError(f"item_sweep takes B = {BLOCK}, g = {GROUP} and "
                         f"S >= 1, not B = {b}, g = {g}, S = {s}")
    if order_g.shape[0] != nb or ibase.shape[0] != nb or n_cand.shape[0] != nb:
        raise ValueError("order_g, ibase and n_cand must have one row a block")
    i_cap = item_block.shape[0]
    out = _outputs(i_cap, b, want_tri, dev)
    if torch.is_tensor(n_items):
        _check("n_items", n_items, torch.int32, 0, dev)
    else:
        if not 0 <= n_items <= i_cap:
            raise ValueError(f"n_items {n_items} outside [0, {i_cap}]")
        if n_items == 0:
            return out
        n_items = torch.tensor(n_items, dtype=torch.int32, device=dev)
    if i_cap == 0:
        return out
    t_out = out[0]
    tri_out = out[1] if want_tri else out[0]
    next_item = torch.empty((1,), dtype=torch.int32, device=dev)  # scratch
    err, ran_generic = cuda_build.launch_instance(
        _entry("item_sweep"), _entry("item_sweep_generic"), dev,
        (tri_pack.data_ptr(), rays.data_ptr(), item_block.data_ptr(),
         ibase.data_ptr(), order_g.data_ptr(), n_cand.data_ptr(),
         t_out.data_ptr(), tri_out.data_ptr(), n_items.data_ptr(), i_cap,
         n_groups, b, s, c, int(want_tri), next_item.data_ptr()))
    if err != 0:
        raise RuntimeError(f"item_sweep launch failed: cudaError {err}")
    with sync.lock:
        launches += 1
        generic_launches += ran_generic
    return out
