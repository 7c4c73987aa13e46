"""The interval culls of the packet cascades and of the worklist: two
hand-written CUDA kernels and their plain versions. Both take the slab test
of csrc/interval.cuh.

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
(a zero entry is +0.0 in both, as in JAX).

Layouts: o_blk, d_blk [nb, R, 3] f32, tm_blk [nb, R] f32 (t_max; negative:
a dead lane), all contiguous; accel.bmin, accel.bmax [C, 3] f32. Any R >= 1
and C >= 1: past C = 16,384 (SMEM_SORT_MAX_C) a thread block sorts in a
device-memory scratch buffer that the wrapper allocates.

The worklist's cull, `worklist_cull(accel, o_blk, d_blk, tm_blk, cap,
k_eff, width, levels, super_cap)`, carries the XLA-fused CULL + EXTRACT
of the JAX package's `_build_worklist` (path_tracer_ai_tpu/accel/
worklist.py:169-266): per block of B rays the same bounds and slab test,
against every cluster box (levels 1) or through the supercluster boxes
and their children (levels 2), and the first k_eff candidate ids in
ascending order. It launches csrc/worklist_cull.cu on CUDA tensors or
raises; `worklist_cull_plain` is its plain version (eager torch in row
chunks, `_cull_flat` / `_cull_2level`), which the CPU takes
(accel.worklist._build_worklist dispatches on the device). Both return
(order [nb, width] i32: the ids, C - 1 past the count or on overflow,
zeros in the pad columns [k_eff, width); n_cand [nb] i32, 0 on overflow;
over [nb] bool), equal bit for bit.

The per-ray culls of csrc/ray_cull.cu carry XLA-fused bodies of the JAX
package too: `kslots_cull(accel, origins, directions, t_max, t_min,
k_supers, k_clusters, levels)` the CULL + EXTRACT of kslots'
`_chunk_pipeline` (path_tracer_ai_tpu/accel/kslots.py:110-163: one ray's
slab test, kslots' own rule, against the supers and the children of its
first k_supers supers, or every cluster box; its first k_clusters ids
ascending; the overflow split), and `perray_cull(accel, origins,
directions, t_min, t_max, cap)` the "id" mode of `_perray_candidates`
(path_tracer_ai_tpu/accel/traverse.py:530-603: the comparison-select slab
test against every cluster box, the first cap ids ascending). Each
launches its kernel on CUDA tensors or raises; `kslots_cull_plain` and
`perray_cull_plain`, the eager bodies in row chunks, are what the CPU
takes (accel.kslots._tables and accel.traverse._perray_candidates
dispatch on the device). kslots_cull returns kslots' table dict (cid [N,
k_clusters] i32, n_slots, n_cand [N] i32; over, over_supers,
over_clusters, phantom_only, live [N] bool), perray_cull (order [N, cap]
i32, n_cand [N] i32 clipped to cap, overflow [N] bool); each equal to its
plain version bit for bit.

The exact shadow cull, `exact_cull(accel, o_blk, d_blk, tm_blk, t_min,
ksup)`, carries the XLA-fused body of the JAX package's
`_exact_block_candidates` (path_tracer_ai_tpu/accel/traverse.py:205-397:
each live lane's slab test against the supers and the children of the
block's first ksup supers, OR'd per block, the exact ids ordered by their
conservative entry). It launches packet_cull (the conservative tables,
which overflow blocks keep) and csrc/packet_cull.cu's exact_cull, which
rewrites the other rows in place, or raises; `exact_cull_plain`, the
eager body in EXACT_CULL_ELEMS steps (moved from accel/traverse.py), is
what the CPU takes (accel.traverse._exact_block_candidates dispatches on
the device). Both return the tables of block_candidates, equal bit for
bit. `perray_entry(accel, origins, directions, t_min, t_max, cap)`, in
csrc/ray_cull.cu, carries `_perray_candidates` in order_mode "entry"
(the first min(cap, C) clusters of each ray by slab entry);
`perray_entry_plain` is its plain version. Both return (order [N, cap]
i32, n_cand [N] i32, entry [N, cap] f32, overflow [N] bool).

The pair tables' CULL + PACK, `pair_tables(accel, origins, directions,
t_min, t_max, cap, pair_budget, tile_rays, pair_align)`, carries the
XLA-fused body of the JAX package's `build_pair_tables`
(path_tracer_ai_tpu/accel/pairs.py:61-190: the comparison-select slab
test of every ray against every cluster box, the ranks of its candidates
in their clusters' segments in ray order, the segments padded to whole
tiles and the cluster-major table). It launches csrc/ray_cull.cu's three
pair kernels on CUDA tensors or raises; `pair_tables_plain`, the eager
body in row steps (moved from accel/pairs.py), is what the CPU takes
(accel.pairs.build_pair_tables dispatches on the device). Both return
(pair_ray [P] i32, tile_cluster [P / T] i32, dst [N, cap] i32, n_cand [N]
i32, overflow [N] bool, n_tiles [] i32 on the device), equal bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "packet_cull"
WORKLIST_SOURCE = "worklist_cull"
RAY_SOURCE = "ray_cull"
# the largest C whose sort fits one thread block's shared memory
# (8 * pow2(C) + 4 * C bytes; csrc/packet_cull.cu SMEM_LIMIT)
SMEM_SORT_MAX_C = 16384

# Elements of each [rows, width] temporary of the plain worklist cull
# (width C for the flat cull, Cs + super_cap * super_size for the 2-level
# one): block rows are culled this many at a time. The tables do not
# depend on the step.
CULL_ELEMS = 1 << 23

# Elements of each [rows, R, K] temporary of the plain exact cull's
# per-lane slab stages (64 MB in f32): its block rows are culled this many
# at a time. The results do not depend on the step.
EXACT_CULL_ELEMS = 1 << 24
# the dynamic shared memory an exact_cull thread block may take
# (csrc/packet_cull.cu SMEM_LIMIT)
EXACT_SMEM_LIMIT = 227 * 1024 - 1024

# Kernel launches since the last reset, packet_cull's, exact_cull's,
# worklist_cull's, kslots_cull's, perray_cull's, perray_entry's and the
# pair tables' (one a call of pair_tables, which launches its three
# kernels; the plain versions count nothing); updated under sync.lock (the
# mesh's workers launch from several threads).
launches = 0
exact_launches = 0
worklist_launches = 0
kslots_launches = 0
perray_launches = 0
entry_launches = 0
pair_launches = 0


def reset_launches() -> None:
    global launches, worklist_launches, kslots_launches, perray_launches
    global pair_launches, exact_launches, entry_launches
    with sync.lock:
        launches = worklist_launches = kslots_launches = perray_launches = 0
        pair_launches = exact_launches = entry_launches = 0


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
        # max(lb, 0) as JAX's jnp.maximum gives it: a zero lb, -0.0 too,
        # enters at +0.0 (the kernel writes the same bits)
        entry = torch.where(cand, torch.where(lb > 0.0, lb, 0.0), INF)
        order = torch.argsort(entry, dim=1, stable=True)
        orders.append(order.to(torch.int32))
        if with_entry:
            entries.append(torch.gather(entry, 1, order))
        ncands.append(cand.sum(dim=1).to(torch.int32))
    return (torch.cat(orders), torch.cat(ncands),
            torch.cat(entries) if with_entry else None)


def _check(tensors, who="block_candidates", device=True):
    """Type, rank and layout of every (name, tensor, ndim) first, then
    (unless device is False) the device, so that each check can be shown to
    fire on the CPU."""
    for name, x, ndim in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
        if x.dim() != ndim:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{ndim} dims")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _ndim in tensors if device else ():
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}: {who} launches "
                             f"the CUDA kernel (the CPU takes {who}_plain)")


def _lib():
    lib = cuda_build.load(SOURCE)
    fn = lib.packet_cull
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.packet_cull_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.packet_cull_scratch_bytes.restype = ctypes.c_longlong
        lib.exact_cull.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
        lib.exact_cull.restype = ctypes.c_int
        lib.exact_cull_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.exact_cull_smem_bytes.restype = ctypes.c_longlong
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


# ---- the exact shadow cull: exact_cull --------------------------------------

def _slab_lanes(o, d, hi0, bmn, bmx, t_min):
    """Sign-select slab of every lane against boxes: o, d [R, B, 3], hi0
    [R, B] (-inf for dead lanes); bmn / bmx [K, 3] (shared) or [R, K, 3]
    (per block). Returns pass [R, B, K] bool. Unlike _interval_slab's
    min/max form, an inverted box (min > max) fails every lane. A NaN
    (origin on a slab plane of an axis-parallel ray) must not exclude: it
    is guarded to the identity bound."""
    inv = 1.0 / d
    k = bmn.shape[-2]
    lo = torch.full(o.shape[:2] + (k,), float(t_min), dtype=torch.float32,
                    device=o.device)
    hi = hi0[..., None]
    for a in range(3):
        bl = bmn[None, None, :, a] if bmn.dim() == 2 else bmn[:, None, :, a]
        bh = bmx[None, None, :, a] if bmx.dim() == 2 else bmx[:, None, :, a]
        iv = inv[..., a][..., None]
        o_ = o[..., a][..., None]
        pos = iv >= 0.0
        tn = (torch.where(pos, bl, bh) - o_) * iv
        tf = (torch.where(pos, bh, bl) - o_) * iv
        tn = torch.where(torch.isnan(tn), -INF, tn)
        tf = torch.where(torch.isnan(tf), INF, tf)
        lo = torch.maximum(lo, tn)
        hi = torch.minimum(hi, tf)
    return lo <= hi


def exact_cull_plain(accel, o_blk, d_blk, tm_blk, t_min, ksup: int = 16,
                     live_blocks=None):
    """Per-ray-exact OR-union candidate clusters per block
    (traverse.py:205-398) in eager torch: the union over a block's live
    lanes of the clusters each lane's own slab test passes, through the
    2-level hierarchy:

      1. each lane's slab against the supercluster AABBs, OR'd per block;
      2. the block's super shortlist: its first `ksup` supers in ascending
         id (the reference's top_k of -id, here _extract_k's cumsum rank);
      3. each lane's slab against the shortlisted supers' child AABBs,
         OR'd per block; non-candidates (and ids past C) become the
         sentinel C.

    A block whose super union exceeds ksup takes the conservative list
    (traverse._block_candidates), which holds every exact candidate. The
    exact ids are ordered by their conservative entry (stable sort: ties
    keep ascending ids), so the interface is _block_candidates': (order
    [nb, C] i32, n_cand [nb] i32, entry_sorted [nb, C]). The per-lane
    stages run EXACT_CULL_ELEMS elements a step. live_blocks (an int; valid
    only when blocks from it on are all dead, as on a wave sorted
    dead-last): those blocks keep n_cand = 0, which is what the stages
    would give them."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.accel.worklist import _extract_k

    nb, bs = o_blk.shape[:2]
    dev = o_blk.device
    c = accel.num_clusters
    cs = accel.num_supers
    ss = accel.super_size
    kx = min(ksup, cs)
    kchild = kx * ss

    # the conservative list: overflow blocks' candidates, and the entries
    # that order the exact ones
    order_cons, n_cons, entry_cons = traverse._block_candidates(
        accel, o_blk, d_blk, tm_blk)
    ids = torch.full((nb, kchild), c, dtype=torch.int64, device=dev)
    n_ex = torch.zeros((nb,), dtype=torch.int32, device=dev)
    n_sup = torch.zeros((nb,), dtype=torch.int32, device=dev)
    entry_ids = torch.full((nb, kchild), INF, dtype=torch.float32,
                           device=dev)
    child = torch.arange(ss, dtype=torch.int64, device=dev)
    inf_col = torch.full((1, 1), INF, dtype=torch.float32, device=dev)
    n_live = nb if live_blocks is None else min(int(live_blocks), nb)
    rows = max(1, EXACT_CULL_ELEMS // (bs * max(kchild, cs)))
    for lo in range(0, n_live, rows):
        hi = min(lo + rows, n_live)
        oc, dc, tc = o_blk[lo:hi], d_blk[lo:hi], tm_blk[lo:hi]
        r = hi - lo
        hi0 = torch.where(tc >= 0.0, tc, -INF)  # dead lanes fail every box
        # 1. each lane against the supers, OR'd per block
        sup_blk = _slab_lanes(oc, dc, hi0, accel.sbmin, accel.sbmax,
                              t_min).any(dim=1)
        n_sup[lo:hi] = sup_blk.sum(dim=1).to(torch.int32)
        # 2. the shortlist; slots past n_sup hold a repeat of super cs - 1
        sup_ids = _extract_k(sup_blk, kx, cs - 1).long()
        slot_ok = (torch.arange(kx, device=dev)[None, :]
                   < n_sup[lo:hi, None])
        # 3. each lane against the shortlisted children (padding children
        # hold inverted boxes, which fail every lane)
        cbmn = accel.cbmin[sup_ids].reshape(r, kchild, 3)
        cbmx = accel.cbmax[sup_ids].reshape(r, kchild, 3)
        cand = _slab_lanes(oc, dc, hi0, cbmn, cbmx, t_min).any(dim=1)
        cand &= slot_ok.repeat_interleave(ss, dim=1)
        cids = (sup_ids[:, :, None] * ss + child).reshape(r, kchild)
        idc = torch.where(cand & (cids < c), cids, c)
        n_ex[lo:hi] = (idc < c).sum(dim=1).to(torch.int32)
        # each id's conservative entry (the sentinel C: +inf, sorts last)
        entry_all = torch.empty_like(entry_cons[lo:hi]).scatter_(
            1, order_cons[lo:hi].long(), entry_cons[lo:hi])
        ent = torch.gather(torch.cat([entry_all, inf_col.expand(r, 1)], 1),
                           1, idc)
        eperm = torch.argsort(ent, dim=1, stable=True)
        ids[lo:hi] = torch.gather(idc, 1, eperm)
        entry_ids[lo:hi] = torch.gather(ent, 1, eperm)
    over = n_sup > kx

    # the uniform [nb, C] order: exact ids first (sentinel-padded) for
    # blocks within the cap, the conservative list for the others
    if kchild < c:
        ids = torch.nn.functional.pad(ids, (0, c - kchild), value=c)
        entry_ids = torch.nn.functional.pad(entry_ids, (0, c - kchild),
                                            value=INF)
    else:
        ids, entry_ids = ids[:, :c], entry_ids[:, :c]
    order = torch.where(over[:, None], order_cons,
                        torch.clamp(ids, max=c - 1).to(torch.int32))
    entry_sorted = torch.where(over[:, None], entry_cons, entry_ids)
    n_cand = torch.where(over, n_cons, n_ex)
    return order, n_cand, entry_sorted


def exact_occupancy(r: int, cs: int, kx: int, ss: int) -> dict:
    """exact_cull's registers and resident warps per SM at blocks of r rays
    and a shortlist of kx supers of ss (needs the card)."""
    from path_tracer_ai_tpu_torch.accel.cuda_ctiles import read_occupancy

    return read_occupancy(cuda_build.load(SOURCE).exact_cull_occupancy, r,
                          cs, kx, ss)


def exact_cull(accel, o_blk, d_blk, tm_blk, t_min, ksup: int = 16):
    """The exact cull on the card: one packet_cull launch (the
    conservative tables, with entries) and one exact_cull launch, which
    overwrites the rows of the blocks within the super shortlist in place:
    (order [nb, C] i32, n_cand [nb] i32, entry_sorted [nb, C] f32), as
    exact_cull_plain (at any live_blocks: a block with no live lane needs
    no count). Raises on a tensor that is not a contiguous f32 CUDA tensor
    of the layout above, on bad sizes, and where a launch fails."""
    tensors = (("o_blk", o_blk, 3), ("d_blk", d_blk, 3),
               ("tm_blk", tm_blk, 2), ("sbmin", accel.sbmin, 2),
               ("sbmax", accel.sbmax, 2), ("cbmin", accel.cbmin, 3),
               ("cbmax", accel.cbmax, 3))
    _check(tensors, device=False)
    c, cs, ss = accel.num_clusters, accel.num_supers, accel.super_size
    if (ksup < 1 or tuple(accel.sbmin.shape) != (cs, 3)
            or accel.sbmax.shape != accel.sbmin.shape
            or tuple(accel.cbmin.shape) != (cs, ss, 3)
            or accel.cbmax.shape != accel.cbmin.shape or cs * ss < c):
        raise ValueError(f"exact_cull takes ksup >= 1, supers [Cs, 3] and "
                         f"children [Cs, ss, 3] with Cs * ss >= C; not ksup "
                         f"= {ksup}, supers {tuple(accel.sbmin.shape)}, "
                         f"children {tuple(accel.cbmin.shape)}, C = {c}")
    _check(tensors, who="exact_cull")
    if any(x.device != o_blk.device for x in (accel.sbmin, accel.sbmax,
                                             accel.cbmin, accel.cbmax)):
        raise ValueError("exact_cull takes every tensor on one card")
    kx = min(ksup, cs)
    lib = _lib()
    smem = lib.exact_cull_smem_bytes(cs, kx, ss)
    if smem > EXACT_SMEM_LIMIT:
        raise ValueError(f"exact_cull keeps a block's {kx} x {ss} child "
                         f"slots in {smem} bytes of shared memory, past "
                         f"{EXACT_SMEM_LIMIT}: use a smaller ksup")
    order, n_cand, entry = block_candidates(accel, o_blk, d_blk, tm_blk)
    _exact_launch(accel, o_blk, d_blk, tm_blk, t_min, ksup, order, n_cand,
                  entry)
    return order, n_cand, entry


def _exact_launch(accel, o_blk, d_blk, tm_blk, t_min, ksup, order, n_cand,
                  entry) -> None:
    """exact_cull's kernel alone on checked inputs: rewrites in place the
    rows of packet_cull's tables (order, n_cand, entry, of the same rays)
    whose blocks are within the super shortlist. Applied twice it gives
    the same tables (an exact row holds its ids' entries in its finite
    prefix too), so a timing loop may launch it on one set of tables."""
    global exact_launches
    nb, r = o_blk.shape[:2]
    if nb == 0:
        return
    err = cuda_build.launch(
        _lib().exact_cull, o_blk.device, o_blk.data_ptr(), d_blk.data_ptr(),
        tm_blk.data_ptr(), float(t_min), accel.sbmin.data_ptr(),
        accel.sbmax.data_ptr(), accel.cbmin.data_ptr(),
        accel.cbmax.data_ptr(), nb, r, accel.num_clusters, accel.num_supers,
        accel.super_size, min(ksup, accel.num_supers), order.data_ptr(),
        n_cand.data_ptr(), entry.data_ptr())
    if err != 0:
        raise RuntimeError(f"exact_cull launch failed: cudaError {err}")
    with sync.lock:
        exact_launches += 1


# ---- the worklist's cull: worklist_cull ------------------------------------

def _cull_flat(accel, oc, dc, tc, cap, k_eff):
    """Blocks vs every cluster AABB: (order [rows, k_eff] ascending ids,
    n_cand (0 on overflow), over)."""
    from path_tracer_ai_tpu_torch.accel.traverse import (
        _interval_slab,
        _ray_block_bounds,
    )
    from path_tracer_ai_tpu_torch.accel.worklist import _extract_k

    c = accel.num_clusters
    olo, ohi, dlo, dhi = _ray_block_bounds(oc, dc, live=tc >= 0.0)
    lb, ub = _interval_slab(accel.bmin, accel.bmax, olo, ohi, dlo, dhi)
    tmax_ub = tc.amax(dim=1)
    # Inclusive bound (flat AABBs stay in) and the dead-block kill.
    cand = ((lb <= ub) & (ub >= 0.0) & (lb <= tmax_ub[:, None])
            & (tmax_ub >= 0.0)[:, None])
    n_cand = cand.sum(dim=1).to(torch.int32)
    over = n_cand > cap
    order = _extract_k(cand & ~over[:, None], k_eff, c - 1)
    return order, torch.where(over, 0, n_cand), over


def _cull_2level(accel, oc, dc, tc, cap, k_eff, super_cap):
    """Supercluster prefilter, then the child AABBs of the surviving supers.

    The candidates are child ids sorder * ss + j. `_extract_k` on the super
    slots gives ascending super ids, so along a row the valid child columns
    hold ascending ids and the first k set columns are the k smallest ids,
    the reference's top_k over -child. The padding children of a partly
    filled last super carry inverted boxes; `_interval_slab` (as the
    reference's) does not fail them, so they count as candidates (ids >= C,
    clamped to C - 1, or left past k_eff where the zero padding of
    order_g stands in): repeats of real candidates, which change no
    result."""
    from path_tracer_ai_tpu_torch.accel.traverse import (
        _interval_slab,
        _ray_block_bounds,
    )
    from path_tracer_ai_tpu_torch.accel.worklist import _extract_k

    c = accel.num_clusters
    rows = oc.shape[0]
    dev = oc.device
    ss = accel.super_size
    cs = accel.num_supers
    scap = min(super_cap, cs)
    olo, ohi, dlo, dhi = _ray_block_bounds(oc, dc, live=tc >= 0.0)
    tmax_ub = tc.amax(dim=1)
    live = (tmax_ub >= 0.0)[:, None]

    lbs, ubs = _interval_slab(accel.sbmin, accel.sbmax, olo, ohi, dlo, dhi)
    cand_s = (lbs <= ubs) & (ubs >= 0.0) & (lbs <= tmax_ub[:, None]) & live
    ns = cand_s.sum(dim=1).to(torch.int32)
    over_s = ns > scap  # supers past the cap are unseen -> fallback
    sorder = _extract_k(cand_s & ~over_s[:, None], scap, cs - 1).long()
    slot_ok = torch.arange(scap, device=dev)[None, :] < ns[:, None]

    child = (sorder[:, :, None] * ss
             + torch.arange(ss, device=dev)[None, None, :]).reshape(
                 rows, scap * ss)
    cbmin = accel.cbmin[sorder].reshape(rows, scap * ss, 3)
    cbmax = accel.cbmax[sorder].reshape(rows, scap * ss, 3)
    lb, ub = _interval_slab(cbmin, cbmax, olo, ohi, dlo, dhi)
    cand = ((lb <= ub) & (ub >= 0.0) & (lb <= tmax_ub[:, None])
            & slot_ok.repeat_interleave(ss, dim=1) & live)
    n_cand = cand.sum(dim=1).to(torch.int32)
    over = over_s | (n_cand > cap)
    cols = _extract_k(cand & ~over[:, None], k_eff, scap * ss).long()
    child = torch.nn.functional.pad(child, (0, 1), value=c - 1)
    order = torch.clamp(torch.gather(child, 1, cols), max=c - 1)
    return order.to(torch.int32), torch.where(over, 0, n_cand), over


def worklist_cull_plain(accel, o_blk, d_blk, tm_blk, cap: int, k_eff: int,
                        width: int, levels: int, super_cap: int = 32,
                        row_chunk: int = 1 << 13):
    """The worklist's cull in eager torch, at most `row_chunk` (and
    CULL_ELEMS / width of its temporaries) blocks at a time: (order [nb,
    width] i32, n_cand [nb] i32, over [nb] bool), as worklist_cull. The
    tables do not depend on the step."""
    nb = o_blk.shape[0]
    elems = accel.num_clusters
    if levels == 2:
        elems = (accel.num_supers
                 + min(super_cap, accel.num_supers) * accel.super_size)
    step = max(1, min(row_chunk, CULL_ELEMS // elems))
    orders, ncands, overs = [], [], []
    for lo in range(0, nb, step):
        args = (accel, o_blk[lo:lo + step], d_blk[lo:lo + step],
                tm_blk[lo:lo + step], cap, k_eff)
        order, n_cand, over = (_cull_2level(*args, super_cap) if levels == 2
                               else _cull_flat(*args))
        orders.append(order)
        ncands.append(n_cand)
        overs.append(over)
    order = torch.cat(orders)
    if width > k_eff:
        order = torch.nn.functional.pad(order, (0, width - k_eff))
    return order, torch.cat(ncands), torch.cat(overs)


def _worklist_lib():
    lib = cuda_build.load(WORKLIST_SOURCE)
    fn = lib.worklist_cull
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return lib


def worklist_occupancy() -> dict:
    """worklist_cull's registers and resident warps per SM (needs the
    card)."""
    from path_tracer_ai_tpu_torch.accel.cuda_ctiles import read_occupancy

    return read_occupancy(
        cuda_build.load(WORKLIST_SOURCE).worklist_cull_occupancy)


def worklist_cull(accel, o_blk, d_blk, tm_blk, cap: int, k_eff: int,
                  width: int, levels: int, super_cap: int = 32):
    """The worklist's cull on the card, one launch: (order [nb, width] i32,
    n_cand [nb] i32, over [nb] bool), as worklist_cull_plain. levels 1
    culls against accel.bmin / bmax, levels 2 through accel.sbmin / sbmax
    and cbmin / cbmax (the first min(super_cap, Cs) candidate supers).
    Raises on a tensor that is not a contiguous f32 CUDA tensor of the
    layout above, on bad sizes, and where the launch fails."""
    global worklist_launches
    if levels not in (1, 2):
        raise ValueError(f"worklist_cull takes levels 1 or 2, not {levels}")
    boxes = ((("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2))
             if levels == 1 else
             (("sbmin", accel.sbmin, 2), ("sbmax", accel.sbmax, 2),
              ("cbmin", accel.cbmin, 3), ("cbmax", accel.cbmax, 3)))
    tensors = (("o_blk", o_blk, 3), ("d_blk", d_blk, 3),
               ("tm_blk", tm_blk, 2), *boxes)
    _check(tensors, device=False)
    nb, b = o_blk.shape[:2]
    c = accel.num_clusters
    n_boxes = boxes[0][1].shape[0]
    ss = accel.cbmin.shape[1] if levels == 2 else 1
    dev = o_blk.device
    if (o_blk.shape[2] != 3 or d_blk.shape != o_blk.shape
            or tuple(tm_blk.shape) != (nb, b)
            or any(x.shape[-1] != 3 for _n, x, _d in boxes)
            or boxes[1][1].shape != boxes[0][1].shape
            or (levels == 1 and n_boxes != c)
            or (levels == 2 and (tuple(accel.cbmin.shape[:1]) != (n_boxes,)
                                 or accel.cbmax.shape != accel.cbmin.shape
                                 or n_boxes * ss < c))):
        raise ValueError("worklist_cull takes o_blk / d_blk [nb, B, 3], "
                         "tm_blk [nb, B], boxes [C, 3] (levels 1) or "
                         "[Cs, 3] and children [Cs, ss, 3] (levels 2)")
    if b < 1 or c < 1 or not 0 <= k_eff <= width or cap < 0 or super_cap < 0:
        raise ValueError(f"worklist_cull takes B >= 1, C >= 1, cap >= 0 and "
                         f"0 <= k_eff <= width, not B = {b}, C = {c}, cap = "
                         f"{cap}, k_eff = {k_eff}, width = {width}")
    _check(tensors, who="worklist_cull")
    if any(x.device != dev for _n, x, _d in tensors):
        raise ValueError("worklist_cull takes every tensor on one card")
    order = torch.empty((nb, width), dtype=torch.int32, device=dev)
    n_cand = torch.empty((nb,), dtype=torch.int32, device=dev)
    over = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb == 0:
        return order, n_cand, over
    child = ((accel.cbmin.data_ptr(), accel.cbmax.data_ptr())
             if levels == 2 else (None, None))
    err = cuda_build.launch(
        _worklist_lib().worklist_cull, dev, o_blk.data_ptr(),
        d_blk.data_ptr(), tm_blk.data_ptr(), boxes[0][1].data_ptr(),
        boxes[1][1].data_ptr(), *child, nb, b, c, n_boxes, ss, levels, cap,
        min(super_cap, n_boxes), k_eff, width, order.data_ptr(),
        n_cand.data_ptr(), over.data_ptr())
    if err != 0:
        raise RuntimeError(f"worklist_cull launch failed: cudaError {err}")
    with sync.lock:
        worklist_launches += 1
    return order, n_cand, over


# ---- the per-ray culls: kslots_cull, perray_cull ---------------------------

# the largest super list a warp of kslots_cull keeps (csrc/ray_cull.cu)
MAX_SUPERS = 1536


def _kslots_chunk(accel, oc, dc, tc, t_min, k_supers: int, k_clusters: int,
                  levels: int) -> dict:
    """CULL + EXTRACT for one row chunk (kslots.py:106-163): the [R, K] cid
    table (clamped to C - 1, phantom children included), n_slots (0 on
    overflow), over, n_cand, and the overflow split (over_supers,
    over_clusters, phantom_only)."""
    from path_tracer_ai_tpu_torch.accel import worklist
    from path_tracer_ai_tpu_torch.accel.kslots import _ray_slab

    r = oc.shape[0]
    c = accel.num_clusters
    dev = oc.device
    live = tc >= 0.0
    lo0 = torch.full((r,), float(t_min), dtype=torch.float32, device=dev)
    hi0 = torch.where(live, tc, -INF)

    if levels == 2:
        ss = accel.super_size
        cs = accel.num_supers
        cand_s = _ray_slab(accel.sbmin, accel.sbmax, oc, dc, lo0, hi0)
        over_s = cand_s.sum(dim=1) > k_supers
        sup = worklist._extract_k(cand_s, k_supers, cs).long()
        sup_c = torch.clamp(sup, max=cs - 1)
        cbmin = accel.cbmin[sup_c].reshape(r, k_supers * ss, 3)
        cbmax = accel.cbmax[sup_c].reshape(r, k_supers * ss, 3)
        sup_live = (sup < cs).repeat_interleave(ss, dim=1)
        cand = _ray_slab(cbmin, cbmax, oc, dc, lo0, hi0) & sup_live
        cid_table = (sup_c[:, :, None] * ss
                     + torch.arange(ss, device=dev)[None, None, :]).reshape(
                         r, k_supers * ss)
        n_real = (cand & (cid_table < c)).sum(dim=1)
    else:
        cand = _ray_slab(accel.bmin, accel.bmax, oc, dc, lo0, hi0)
        over_s = torch.zeros((r,), dtype=torch.bool, device=dev)
        cid_table = None
        n_real = None

    n_cand = cand.sum(dim=1).to(torch.int32)
    over = over_s | (n_cand > k_clusters)
    cand = cand & ~over[:, None]

    cols = cand.shape[1]
    slot = worklist._extract_k(cand, k_clusters, cols).long()   # [R, K]
    if cid_table is None:
        cid = torch.clamp(slot, max=cols - 1)
    else:
        cid = torch.gather(cid_table, 1, torch.clamp(slot, max=cols - 1))
    cid = torch.clamp(cid, max=c - 1).to(torch.int32)
    over_c = over & ~over_s
    phantom = (over_c & (n_real <= k_clusters) if n_real is not None
               else torch.zeros_like(over))
    return {"cid": cid, "n_slots": torch.where(over, 0, n_cand),
            "over": over, "n_cand": n_cand, "over_supers": over_s,
            "over_clusters": over_c, "phantom_only": phantom, "live": live}


def kslots_cull_plain(accel, origins, directions, t_max, t_min,
                      k_supers: int, k_clusters: int, levels: int,
                      row_chunk: int = 1 << 15) -> dict:
    """kslots' cull in eager torch, `row_chunk` rays at a time (the tables
    do not depend on the step): the dict of kslots_cull."""
    parts = [_kslots_chunk(accel, origins[a:a + row_chunk],
                           directions[a:a + row_chunk],
                           t_max[a:a + row_chunk], t_min, k_supers,
                           k_clusters, levels)
             for a in range(0, max(origins.shape[0], 1), row_chunk)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _ray_lib():
    lib = cuda_build.load(RAY_SOURCE)
    if lib.kslots_cull.argtypes is None:
        lib.kslots_cull.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8)
        lib.kslots_cull.restype = ctypes.c_int
        lib.perray_cull.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
        lib.perray_cull.restype = ctypes.c_int
        lib.perray_entry.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
        lib.perray_entry.restype = ctypes.c_int
        lib.pair_tables.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 10)
        lib.pair_tables.restype = ctypes.c_int
    return lib


def ray_occupancy(k_supers: int = 6) -> dict:
    """Registers and resident warps per SM of kslots_cull (a list of
    k_supers supers a warp), perray_cull and perray_entry (needs the
    card)."""
    from path_tracer_ai_tpu_torch.accel.cuda_ctiles import read_occupancy

    lib = cuda_build.load(RAY_SOURCE)
    return {"kslots_cull": read_occupancy(lib.kslots_cull_occupancy,
                                          k_supers),
            "perray_cull": read_occupancy(lib.perray_cull_occupancy),
            "perray_entry": read_occupancy(lib.perray_entry_occupancy)}


def pair_occupancy(c: int) -> dict:
    """Registers and resident warps per SM of the pair tables' cull, scan
    and rank kernels (the rank at C clusters; needs the card)."""
    from path_tracer_ai_tpu_torch.accel.cuda_ctiles import read_occupancy

    fn = cuda_build.load(RAY_SOURCE).pair_tables_occupancy
    return {name: read_occupancy(fn, which, c)
            for which, name in enumerate(("pair_cull", "pair_scan",
                                          "pair_rank"))}


def _ray_inputs(who, origins, directions, t_max, boxes):
    """Checks the rays [N, 3], t_max [N] and the boxes ((name, tensor,
    ndim)...) of a per-ray cull: type, rank, layout, shapes, then the
    device."""
    tensors = (("origins", origins, 2), ("directions", directions, 2),
               ("t_max", t_max, 1), *boxes)
    _check(tensors, device=False)
    n = origins.shape[0]
    if (origins.shape[1] != 3 or directions.shape != origins.shape
            or tuple(t_max.shape) != (n,)
            or any(x.shape[-1] != 3 for _n, x, _d in boxes)
            or boxes[1][1].shape != boxes[0][1].shape):
        raise ValueError(f"{who} takes origins / directions [N, 3], t_max "
                         f"[N] and boxes [..., 3]")
    _check(tensors, who=who)
    if any(x.device != origins.device for _n, x, _d in tensors):
        raise ValueError(f"{who} takes every tensor on one card")
    return n


def kslots_cull(accel, origins, directions, t_max, t_min, k_supers: int,
                k_clusters: int, levels: int) -> dict:
    """kslots' cull on the card, one launch: the dict of kslots_cull_plain
    (cid [N, k_clusters] i32, n_slots, n_cand [N] i32; over, over_supers,
    over_clusters, phantom_only, live [N] bool). levels 1 culls against
    accel.bmin / bmax, levels 2 through accel.sbmin / sbmax and cbmin /
    cbmax. Raises on a tensor that is not a contiguous f32 CUDA tensor of
    the layout above, on bad sizes, and where the launch fails."""
    global kslots_launches
    if levels not in (1, 2):
        raise ValueError(f"kslots_cull takes levels 1 or 2, not {levels}")
    boxes = ((("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2))
             if levels == 1 else
             (("sbmin", accel.sbmin, 2), ("sbmax", accel.sbmax, 2),
              ("cbmin", accel.cbmin, 3), ("cbmax", accel.cbmax, 3)))
    c = accel.num_clusters
    n_boxes = boxes[0][1].shape[0]
    ss = accel.cbmin.shape[1] if levels == 2 else 1
    if (c < 1 or k_clusters < 0
            or (levels == 1 and n_boxes != c)
            or (levels == 2 and not 1 <= min(k_supers, n_boxes) <= MAX_SUPERS)
            or (levels == 2 and (tuple(accel.cbmin.shape[:1]) != (n_boxes,)
                                 or accel.cbmax.shape != accel.cbmin.shape
                                 or n_boxes * ss < c))):
        raise ValueError(f"kslots_cull takes C >= 1 boxes [C, 3] (levels 1) "
                         f"or supers [Cs, 3] and children [Cs, ss, 3] with "
                         f"1 <= min(k_supers, Cs) <= {MAX_SUPERS} (levels 2), "
                         f"k_clusters >= 0; not C = {c}, k_supers = "
                         f"{k_supers}, k_clusters = {k_clusters}")
    n = _ray_inputs("kslots_cull", origins, directions, t_max, boxes)
    dev = origins.device
    out = {"cid": torch.empty((n, k_clusters), dtype=torch.int32, device=dev),
           **{k: torch.empty((n,), dtype=torch.int32, device=dev)
              for k in ("n_slots", "n_cand")},
           **{k: torch.empty((n,), dtype=torch.bool, device=dev)
              for k in ("over", "over_supers", "over_clusters",
                        "phantom_only")}}
    out["live"] = t_max >= 0.0
    if n == 0:
        return out
    child = ((accel.cbmin.data_ptr(), accel.cbmax.data_ptr())
             if levels == 2 else (None, None))
    err = cuda_build.launch(
        _ray_lib().kslots_cull, dev, origins.data_ptr(),
        directions.data_ptr(), t_max.data_ptr(), float(t_min),
        boxes[0][1].data_ptr(), boxes[1][1].data_ptr(), *child, n, c,
        n_boxes, ss, levels, k_supers, k_clusters, out["cid"].data_ptr(),
        out["n_cand"].data_ptr(), out["n_slots"].data_ptr(),
        *(out[k].data_ptr() for k in ("over", "over_supers",
                                      "over_clusters", "phantom_only")))
    if err != 0:
        raise RuntimeError(f"kslots_cull launch failed: cudaError {err}")
    with sync.lock:
        kslots_launches += 1
    return out


def perray_slab_plain(accel, oc, dc, tc, t_min):
    """perray's inclusive slab test of [rows] rays against every cluster
    box, comparison-select form (a 0 * inf NaN keeps the running bound):
    (cand [rows, C] bool, the entry lo [rows, C] f32)."""
    inv = 1.0 / dc
    t0 = (accel.bmin[None] - oc[:, None, :]) * inv[:, None, :]
    t1 = (accel.bmax[None] - oc[:, None, :]) * inv[:, None, :]
    neg = inv[:, None, :] < 0.0
    near = torch.where(neg, t1, t0)
    far = torch.where(neg, t0, t1)
    lo_t = torch.full(near.shape[:2], float(t_min), dtype=torch.float32,
                      device=oc.device)
    hi_t = torch.minimum(tc[:, None].expand(near.shape[:2]),
                         torch.full((), INF, device=oc.device))
    for a in range(3):
        lo_t = torch.where(near[..., a] > lo_t, near[..., a], lo_t)
        hi_t = torch.where(far[..., a] < hi_t, far[..., a], hi_t)
    return hi_t >= lo_t, lo_t


def perray_cull_plain(accel, origins, directions, t_min, t_max, cap: int,
                      row_chunk: int = 1 << 14):
    """perray's candidate lists in order_mode "id", in eager torch,
    `row_chunk` rays at a time: (order [N, cap] i32, n_cand [N] i32
    clipped to cap, overflow [N] bool), as perray_cull."""
    n = origins.shape[0]
    c = accel.num_clusters
    dev = origins.device
    kx = min(cap, c)
    order = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    n_cand = torch.zeros((n,), dtype=torch.int32, device=dev)
    targets = torch.arange(1, kx + 1, dtype=torch.int32, device=dev)
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        cand, _lo_t = perray_slab_plain(accel, origins[lo:hi],
                                        directions[lo:hi], t_max[lo:hi],
                                        t_min)                # [r, C]
        n_cand[lo:hi] = cand.sum(dim=1).to(torch.int32)
        cums = torch.cumsum(cand.to(torch.int32), dim=1)
        ok = torch.searchsorted(cums,
                                targets.expand(hi - lo, kx).contiguous())
        order[lo:hi, :kx] = torch.clamp(ok, max=c - 1).to(torch.int32)
    return order, torch.clamp(n_cand, max=cap), n_cand > cap


def perray_cull(accel, origins, directions, t_min, t_max, cap: int):
    """perray's candidate lists on the card, one launch: (order [N, cap]
    i32, n_cand [N] i32, overflow [N] bool), as perray_cull_plain. Raises
    on a tensor that is not a contiguous f32 CUDA tensor of the layout
    above, on bad sizes, and where the launch fails."""
    global perray_launches
    c = accel.num_clusters
    boxes = (("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2))
    if c < 1 or cap < 0 or tuple(accel.bmin.shape[:1]) != (c,):
        raise ValueError(f"perray_cull takes C >= 1 boxes [C, 3] and cap >= "
                         f"0, not C = {c}, cap = {cap}")
    n = _ray_inputs("perray_cull", origins, directions, t_max, boxes)
    dev = origins.device
    order = torch.empty((n, cap), dtype=torch.int32, device=dev)
    n_cand = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return order, n_cand, overflow
    err = cuda_build.launch(
        _ray_lib().perray_cull, dev, origins.data_ptr(),
        directions.data_ptr(), t_max.data_ptr(), float(t_min),
        accel.bmin.data_ptr(), accel.bmax.data_ptr(), n, c, cap,
        order.data_ptr(), n_cand.data_ptr(), overflow.data_ptr())
    if err != 0:
        raise RuntimeError(f"perray_cull launch failed: cudaError {err}")
    with sync.lock:
        perray_launches += 1
    return order, n_cand, overflow


def perray_entry_plain(accel, origins, directions, t_min, t_max, cap: int,
                       row_chunk: int = 1 << 14):
    """perray's candidate lists in order_mode "entry", in eager torch,
    `row_chunk` rays at a time: (order [N, cap] i32: front to back by slab
    entry, a stable argsort, past the count the non-candidates in id
    order; n_cand [N] i32 clipped to cap; entry [N, cap] f32, the entry t,
    inf past the count; overflow [N] bool), as perray_entry. Columns past
    C, where cap > C, hold 0 and entry inf."""
    n = origins.shape[0]
    c = accel.num_clusters
    dev = origins.device
    kx = min(cap, c)
    entry = torch.full((n, cap), INF, dtype=torch.float32, device=dev)
    order = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    n_cand = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        cand, lo_t = perray_slab_plain(accel, origins[lo:hi],
                                       directions[lo:hi], t_max[lo:hi],
                                       t_min)
        n_cand[lo:hi] = cand.sum(dim=1).to(torch.int32)
        ent = torch.where(cand, lo_t, INF)
        ok = torch.argsort(ent, dim=1, stable=True)[:, :kx]
        order[lo:hi, :kx] = ok.to(torch.int32)
        entry[lo:hi, :kx] = torch.gather(ent, 1, ok)
    return order, torch.clamp(n_cand, max=cap), entry, n_cand > cap


def perray_entry(accel, origins, directions, t_min, t_max, cap: int):
    """perray's candidate lists in order_mode "entry" on the card, one
    launch: (order [N, cap] i32, n_cand [N] i32, entry [N, cap] f32,
    overflow [N] bool), as perray_entry_plain. Raises on a tensor that is
    not a contiguous f32 CUDA tensor of the layout above, on bad sizes,
    and where the launch fails."""
    global entry_launches
    c = accel.num_clusters
    boxes = (("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2))
    if c < 1 or cap < 0 or tuple(accel.bmin.shape[:1]) != (c,):
        raise ValueError(f"perray_entry takes C >= 1 boxes [C, 3] and cap "
                         f">= 0, not C = {c}, cap = {cap}")
    n = _ray_inputs("perray_entry", origins, directions, t_max, boxes)
    dev = origins.device
    order = torch.empty((n, cap), dtype=torch.int32, device=dev)
    entry = torch.empty((n, cap), dtype=torch.float32, device=dev)
    n_cand = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return order, n_cand, entry, overflow
    err = cuda_build.launch(
        _ray_lib().perray_entry, dev, origins.data_ptr(),
        directions.data_ptr(), t_max.data_ptr(), float(t_min),
        accel.bmin.data_ptr(), accel.bmax.data_ptr(), n, c, cap,
        order.data_ptr(), entry.data_ptr(), n_cand.data_ptr(),
        overflow.data_ptr())
    if err != 0:
        raise RuntimeError(f"perray_entry launch failed: cudaError {err}")
    with sync.lock:
        entry_launches += 1
    return order, n_cand, entry, overflow


# ---- the pair tables' CULL + PACK: pair_tables ------------------------------

# Elements of each [rows, C] temporary of the plain pair tables: rows are
# culled this many at a time. The running per-cluster counts carry over,
# so the tables do not depend on the step.
PAIR_CULL_ELEMS = 1 << 22
# The ray tiles of the pair kernels: about this many tiles a call (each a
# thread block of the cull and a warp of the rank), at least
# PAIR_MIN_TILE_RAYS rays a tile. The tables do not depend on the tiling
# (the tests set both to force one ray a tile, or one tile a call).
PAIR_TILES = 512
PAIR_MIN_TILE_RAYS = 8


def pair_capacity(n: int, pair_budget: int, tile_rays: int,
                  pair_align: int) -> int:
    """P, the static pair capacity: n * pair_budget rounded up to whole
    units of tile_rays * pair_align."""
    unit = tile_rays * pair_align
    return -(-(n * pair_budget) // unit) * unit


def pair_tables_plain(accel, origins, directions, t_min, t_max, cap: int,
                      pair_budget: int, tile_rays: int, pair_align: int = 1,
                      row_chunk: int = 1 << 15):
    """The pair tables in eager torch: rows culled at most `row_chunk` (and
    PAIR_CULL_ELEMS / C) at a time, the running per-cluster counts (the
    reference's lax.scan carry) giving each pair its rank inside its
    cluster segment. Returns (pair_ray, tile_cluster, dst, n_cand,
    overflow, n_tiles) as pair_tables; the tables do not depend on either
    step."""
    from path_tracer_ai_tpu_torch.accel.worklist import _extract_k

    n = origins.shape[0]
    c = accel.num_clusters
    dev = origins.device
    t = tile_rays
    p_cap = pair_capacity(n, pair_budget, t, pair_align)
    k_eff = min(cap, c)
    step = max(1, min(row_chunk, PAIR_CULL_ELEMS // c))

    counts = torch.zeros((c,), dtype=torch.int64, device=dev)
    orders, ncands, overs, ranks = [], [], [], []
    for lo in range(0, n, step):
        tc = t_max[lo:lo + step]
        cand = perray_slab_plain(accel, origins[lo:lo + step],
                                 directions[lo:lo + step], tc, t_min)[0]
        cand = cand & (tc >= 0.0)[:, None]
        n_cand = cand.sum(dim=1).to(torch.int32)
        over = n_cand > cap
        cand = cand & ~over[:, None]
        order = _extract_k(cand, k_eff, c - 1)
        ci = cand.to(torch.int64)
        rank_full = counts[None, :] + torch.cumsum(ci, dim=0) - ci
        ranks.append(torch.gather(rank_full, 1, order.long()))
        counts = counts + ci.sum(dim=0)
        orders.append(order)
        ncands.append(torch.where(over, 0, n_cand))
        overs.append(over)
    if n:
        order = torch.cat(orders)
        n_cand = torch.cat(ncands)
        overflow = torch.cat(overs)
        rank = torch.cat(ranks)
    else:
        order = rank = torch.zeros((0, k_eff), dtype=torch.int64, device=dev)
        n_cand = torch.zeros((0,), dtype=torch.int32, device=dev)
        overflow = torch.zeros((0,), dtype=torch.bool, device=dev)

    # Cluster segments, padded so every tile holds exactly one cluster.
    seg = -(-counts // t) * t
    base = torch.cumsum(seg, 0) - seg
    total = seg.sum()

    valid_k = (torch.arange(k_eff, device=dev)[None, :] < n_cand[:, None])
    dst = torch.where(valid_k, base[order.long()] + rank, p_cap)
    # Rays with any pair past the static budget complete via the fallback.
    over_budget = (valid_k & (dst >= p_cap)).any(dim=1)
    overflow = overflow | over_budget
    n_cand = torch.where(over_budget, 0, n_cand)
    dst = torch.where(over_budget[:, None], p_cap, dst)

    # One permutation scatter (unique destinations; slot p_cap is a sink).
    pair_ray = torch.full((p_cap + 1,), -1, dtype=torch.int32, device=dev)
    ray_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    pair_ray[dst.reshape(-1)] = ray_ids.expand(n, k_eff).reshape(-1)
    pair_ray = pair_ray[:p_cap]

    # Tile -> cluster: segment lookup at each tile's first slot.
    tile_starts = torch.arange(p_cap // t, device=dev) * t
    tile_cluster = torch.searchsorted(base, tile_starts, right=True) - 1
    tile_cluster = torch.clamp(tile_cluster, 0, c - 1).to(torch.int32)
    n_tiles = (torch.clamp(total, max=p_cap) // t).to(torch.int32)

    dst = dst.to(torch.int32)
    if k_eff < cap:
        dst = torch.nn.functional.pad(dst, (0, cap - k_eff), value=p_cap)
    return pair_ray, tile_cluster, dst, n_cand, overflow, n_tiles


def pair_tile_rays(n: int) -> int:
    """Rays a tile of the pair kernels: about PAIR_TILES tiles a call."""
    return max(PAIR_MIN_TILE_RAYS, -(-n // PAIR_TILES))


def pair_tables(accel, origins, directions, t_min, t_max, cap: int,
                pair_budget: int, tile_rays: int, pair_align: int = 1):
    """The pair tables on the card, three launches (cull, scan, rank) and
    one fill: (pair_ray [P] i32, tile_cluster [P / T] i32, dst [N, cap]
    i32, n_cand [N] i32, overflow [N] bool, n_tiles [] i32 on the card), as
    pair_tables_plain, in ray tiles of pair_tile_rays(N) rays. Raises on a
    tensor that is not a contiguous f32 CUDA tensor of the layout above,
    on bad sizes, and where a launch fails."""
    global pair_launches
    c = accel.num_clusters
    boxes = (("bmin", accel.bmin, 2), ("bmax", accel.bmax, 2))
    if (c < 1 or cap < 0 or pair_budget < 0 or tile_rays < 1
            or pair_align < 1 or tuple(accel.bmin.shape[:1]) != (c,)):
        raise ValueError(f"pair_tables takes C >= 1 boxes [C, 3], cap >= 0, "
                         f"pair_budget >= 0, tile_rays >= 1 and pair_align "
                         f">= 1, not C = {c}, cap = {cap}, pair_budget = "
                         f"{pair_budget}, tile_rays = {tile_rays}, "
                         f"pair_align = {pair_align}")
    n = _ray_inputs("pair_tables", origins, directions, t_max, boxes)
    rt = pair_tile_rays(n)
    k_eff = min(cap, c)
    p_cap = pair_capacity(n, pair_budget, tile_rays, pair_align)
    if n * k_eff + c * tile_rays >= 1 << 31 or p_cap >= 1 << 31:
        raise ValueError("pair_tables counts its pairs in i32: N * min(cap, "
                         "C) + C * tile_rays and P must stay below 2^31")
    dev = origins.device
    nt = -(-n // rt)
    pair_ray = torch.full((p_cap,), -1, dtype=torch.int32, device=dev)
    tile_cluster = torch.empty((p_cap // tile_rays,), dtype=torch.int32,
                               device=dev)
    dst = torch.empty((n, cap), dtype=torch.int32, device=dev)
    n_cand = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.empty((n,), dtype=torch.bool, device=dev)
    n_tiles = torch.empty((1,), dtype=torch.int32, device=dev)
    order = torch.empty((n, k_eff), dtype=torch.int32, device=dev)
    hist = torch.empty((nt, c), dtype=torch.int32, device=dev)
    base = torch.empty((c,), dtype=torch.int32, device=dev)
    err = cuda_build.launch(
        _ray_lib().pair_tables, dev, origins.data_ptr(),
        directions.data_ptr(), t_max.data_ptr(), float(t_min),
        accel.bmin.data_ptr(), accel.bmax.data_ptr(), n, c, cap, rt,
        tile_rays, p_cap, order.data_ptr(), hist.data_ptr(), base.data_ptr(),
        pair_ray.data_ptr(), tile_cluster.data_ptr(), dst.data_ptr(),
        n_cand.data_ptr(), overflow.data_ptr(), n_tiles.data_ptr())
    if err != 0:
        raise RuntimeError(f"pair_tables launch failed: cudaError {err}")
    with sync.lock:
        pair_launches += 1
    return pair_ray, tile_cluster, dst, n_cand, overflow, n_tiles.reshape(())
