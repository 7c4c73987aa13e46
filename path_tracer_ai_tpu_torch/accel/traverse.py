"""Packet traversal of the cluster structure: the shadow cascade.

Counterpart of accel/traverse.py, the parts the main path runs:
`any_hit_packets` (traverse.py:877-970) and its helpers.

1. SORT  — coherence keys (octant | direction Morton | origin Morton, dead
           rays last) and one stable argsort.
2. CULL  — per block of rays, a conservative interval slab test against
           every cluster AABB; candidates ordered by conservative entry.
3. SWEEP — the cascade: each iteration sweeps the next `group_size`
           candidates of every active block; a stage runs until at most half
           its blocks are active, then compacts them to the front (one
           whole-array gather) and continues on half the slice.

`any_hit_packets` and `closest_hit_packets` run the cascade as the
reference does (`_cascade_stages`): static stages, each ONE launch of the
cascade stage kernel (accel.cuda_cascade.cascade_stage), which keeps the
stage's loop, its active count and k on the card, as the reference's
while_loop does; between stages the compaction is a stable argsort and a
whole-array gather, on the device. Neither reads the host (but the exact
cull's live block count, `live_block_count`). On the CPU the stage runs
its plain version, a host loop over tile_sweep's plain version.

The fused cascades of accel.cuda_anyhit and accel.cuda_closest run the
same static stages, each ONE call of accel.cuda_cascade.fused_stage
(on the card one launch of the stage kernel with the fused folds, whose
sweeps are block_anyhit's and block_closest's bodies); they read the host
once a cascade, the candidate ids' range check. On the CPU their stage
runs its plain version, `_stepped_stage` with the kernels' plain versions.

The perray queries still step their loop on the host (`_cascade_traverse`:
a host read an iteration), sweeping one launch an iteration: the per-ray
K-slot kernel's first-slot instance (accel.cuda_kslots.kslot_sweep,
tie="slot") for closest hits, its any-hit sweep for occlusion. In the
reference these sweeps are XLA-fused bodies, not Pallas kernels. On the
CPU they run the plain eager sweeps `_packet_sweep_closest` /
`_packet_sweep_any`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.accel import (
    cuda_cascade,
    cuda_ctiles,
    cuda_kslots,
)
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.morton import morton3d
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")


class PacketHit(NamedTuple):
    hit: torch.Tensor  # [N] bool
    t: torch.Tensor    # [N] f32 (inf on miss)
    tri: torch.Tensor  # [N] i32 global triangle index (-1 on miss)


def _sort_keys(accel: ClusterAccel, origins, directions, t_max=None,
               mode: str = "dir") -> torch.Tensor:
    """Coherence key (int64; JAX's uint32 key, bit for bit).

    mode="dir":     dead(1) | octant(3) | dir-Morton(9) | origin-Morton(18)
    mode="origin":  dead(1) | origin-Morton(18) | octant(3) | dir-Morton(9)
    mode="octorig": dead(1) | octant(3) | origin-Morton(21)
    mode="origoct": dead(1) | origin-Morton(21) | octant(3)
    """
    octant = (
        (directions[:, 0] < 0).to(torch.int64) * 4
        + (directions[:, 1] < 0).to(torch.int64) * 2
        + (directions[:, 2] < 0).to(torch.int64)
    )
    if mode in ("octorig", "origoct"):
        ocell7 = morton3d(origins, accel.scene_min, accel.scene_max,
                          bits=7).to(torch.int64)
        if mode == "octorig":
            key = (octant << 21) | ocell7
        else:
            key = (ocell7 << 3) | octant
    elif mode in ("dir", "origin"):
        ones = torch.ones((3,), dtype=torch.float32, device=origins.device)
        dcell = morton3d(directions, -ones, ones, bits=3).to(torch.int64)
        ocell = morton3d(origins, accel.scene_min, accel.scene_max,
                         bits=6).to(torch.int64)
        if mode == "origin":
            key = (ocell << 12) | (octant << 9) | dcell
        else:
            key = (octant << 27) | (dcell << 18) | ocell
    else:
        raise ValueError(f"unknown sort mode {mode!r}")
    if t_max is not None:
        key = key | ((t_max < 0.0).to(torch.int64) << 31)
    return key


def _sort_rays(accel, origins, directions, t_max, mode: str):
    """Rays in coherence order (one packed row gather) and the permutation:
    (origins, directions, t_max, perm), sorted[i] = original[perm[i]]."""
    keys = _sort_keys(accel, origins, directions, t_max, mode=mode)
    perm = torch.argsort(keys, stable=True)
    packed = torch.cat([origins, directions, t_max[:, None]], dim=1)[perm]
    return packed[:, 0:3], packed[:, 3:6], packed[:, 6], perm


def _unsort(x, perm):
    """Undo _sort_rays on a per-ray result: out[perm[i]] = x[i]. perm None
    (the wave was not sorted) returns x."""
    if perm is None:
        return x
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _interval_slab(bmin, bmax, olo, ohi, dlo, dhi):
    """Interval-arithmetic slab bounds of ray blocks vs AABBs.

    bmin/bmax: [K, 3] (one box table shared by all blocks) or [B, K, 3]
    (per-block gathered boxes). olo/ohi/dlo/dhi: [B, 3]. Returns (lb, ub)
    [B, K]: for every member ray, slab entry >= lb and exit <= ub.
    torch.minimum/maximum propagate NaN exactly as jnp.minimum/maximum do
    in the reference. An inverted box (min > max) is NOT failed here: its
    numerator interval is reversed, so each axis gives (-huge, +huge)."""
    shared = bmin.dim() == 2
    nb = olo.shape[0]
    kdim = bmin.shape[0] if shared else bmin.shape[1]
    dev = olo.device
    lb = torch.full((nb, kdim), -INF, dtype=torch.float32, device=dev)
    ub = torch.full((nb, kdim), INF, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for a in range(3):
        bl = bmin[None, :, a] if shared else bmin[:, :, a]
        bh = bmax[None, :, a] if shared else bmax[:, :, a]
        nlo = bl - ohi[:, a][:, None]
        nhi = bh - olo[:, a][:, None]
        da_lo = dlo[:, a][:, None]
        da_hi = dhi[:, a][:, None]
        spans_zero = (da_lo <= 0.0) & (da_hi >= 0.0)
        safe_lo = torch.where(torch.abs(da_lo) > 0, da_lo, one)
        safe_hi = torch.where(torch.abs(da_hi) > 0, da_hi, one)
        q1 = nlo / safe_lo
        q2 = nlo / safe_hi
        q3 = nhi / safe_lo
        q4 = nhi / safe_hi
        qmin = torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4))
        qmax = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
        axis_lb = torch.where(spans_zero, -INF, qmin)
        axis_ub = torch.where(spans_zero, INF, qmax)
        lb = torch.maximum(lb, axis_lb)
        ub = torch.minimum(ub, axis_ub)
    return lb, ub


def _ray_block_bounds(o_blk, d_blk, live=None):
    """Per-block origin/direction bounds ([B, R, 3] -> 4 x [B, 3]); dead
    lanes (live False) are left out of the bounds."""
    if live is None:
        return (o_blk.amin(dim=1), o_blk.amax(dim=1),
                d_blk.amin(dim=1), d_blk.amax(dim=1))
    m = live[..., None]
    return (
        torch.where(m, o_blk, INF).amin(dim=1),
        torch.where(m, o_blk, -INF).amax(dim=1),
        torch.where(m, d_blk, INF).amin(dim=1),
        torch.where(m, d_blk, -INF).amax(dim=1),
    )


def _block_interval_bounds(accel, o_blk, d_blk, live=None):
    olo, ohi, dlo, dhi = _ray_block_bounds(o_blk, d_blk, live=live)
    return _interval_slab(accel.bmin, accel.bmax, olo, ohi, dlo, dhi)


def _block_candidates(accel, o_blk, d_blk, t_max_blk, row_chunk: int = 8192):
    """Conservative candidate clusters per ray block, front to back.

    Returns (order [B, C] i32 cluster ids by ascending conservative entry,
    candidates first; n_cand [B] i32; entry_sorted [B, C]). Blocks are
    processed `row_chunk` at a time so the [B, C] temporaries stay small."""
    orders, ncands, entries = [], [], []
    for lo in range(0, o_blk.shape[0], row_chunk):
        ob = o_blk[lo:lo + row_chunk]
        db = d_blk[lo:lo + row_chunk]
        tb = t_max_blk[lo:lo + row_chunk]
        lb, ub = _block_interval_bounds(accel, ob, db, live=tb >= 0.0)
        tmax_ub = tb.amax(dim=1)
        cand = (lb <= ub) & (ub >= 0.0) & (lb <= tmax_ub[:, None])
        entry = torch.where(cand, torch.clamp(lb, min=0.0), INF)
        order = torch.argsort(entry, dim=1, stable=True)
        orders.append(order.to(torch.int32))
        entries.append(torch.gather(entry, 1, order))
        ncands.append(cand.sum(dim=1).to(torch.int32))
    return torch.cat(orders), torch.cat(ncands), torch.cat(entries)


# Elements of each [rows, R, K] temporary of the exact cull's per-lane slab
# stages (64 MB in f32): its block rows are culled this many at a time.
# The results do not depend on the step.
EXACT_CULL_ELEMS = 1 << 24


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


def _exact_block_candidates(accel, o_blk, d_blk, tm_blk, t_min,
                            ksup: int = 16, live_blocks=None):
    """Per-ray-exact OR-union candidate clusters per block
    (traverse.py:205-398): the union over a block's live lanes of the
    clusters each lane's own slab test passes, through the 2-level
    hierarchy:

      1. each lane's slab against the supercluster AABBs, OR'd per block;
      2. the block's super shortlist: its first `ksup` supers in ascending
         id (the reference's top_k of -id, here _extract_k's cumsum rank);
      3. each lane's slab against the shortlisted supers' child AABBs,
         OR'd per block; non-candidates (and ids past C) become the
         sentinel C.

    A block whose super union exceeds ksup takes the conservative list
    (_block_candidates), which holds every exact candidate. The exact ids
    are ordered by their conservative entry (stable sort: ties keep
    ascending ids), so the interface is _block_candidates': (order [nb, C]
    i32, n_cand [nb] i32, entry_sorted [nb, C]). The per-lane stages run
    EXACT_CULL_ELEMS elements a step. live_blocks (an int; valid only when
    the rays are sorted dead-last): blocks from it on are all dead and
    keep n_cand = 0, which is what the stages would give them."""
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
    order_cons, n_cons, entry_cons = _block_candidates(accel, o_blk, d_blk,
                                                       tm_blk)
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


def live_block_count(t_max_blk) -> int:
    """Blocks with a live lane (t_max >= 0), read once by the host; on a
    wave sorted dead-last they are a prefix."""
    return sync.host_int((t_max_blk >= 0.0).any(dim=1).sum())


def _cascade_stages(block_arrays, carry, stage, min_blocks: int = 32):
    """Cascaded block traversal with the reference's structure
    (traverse.py:439-520): static stages of halving size, each run to its
    end by ONE call of `stage`, as one while_loop of the reference.

    stage(blocks, carry, k, threshold) -> (carry, k, act) runs a stage on
    the slice until at most `threshold` of its blocks are active (0 in the
    last stage, when fewer than 2 * min_blocks remain), updating the carry
    slices and k ([1] i32 on the device) in place; act [size] bool is the
    active rule at the final k. Between stages the active blocks go to the
    front by a stable argsort and ONE whole-array gather; nothing is read
    back to the host here. Returns (carry, blk_index): blk_index[i] =
    original block at row i."""
    nb = block_arrays[0].shape[0]
    dev = block_arrays[0].device
    full = (list(block_arrays) + list(carry)
            + [torch.arange(nb, dtype=torch.int64, device=dev)])
    n_in = len(block_arrays)
    n_carry = len(carry)
    k = torch.zeros((1,), dtype=torch.int32, device=dev)
    size = nb
    while True:
        last_stage = size // 2 < min_blocks
        sl = [a[:size] for a in full]
        _carry, k, act = stage(sl[:n_in], sl[n_in:n_in + n_carry], k,
                               0 if last_stage else size // 2)
        if last_stage:
            break
        perm = torch.argsort((~act).to(torch.uint8), stable=True)
        row_idx = torch.cat([perm, torch.arange(size, nb, dtype=torch.int64,
                                                device=dev)])
        full = [a[row_idx] for a in full]
        size //= 2
    return full[n_in:n_in + n_carry], full[-1]


def _stepped_stage(blocks, carry, k: int, threshold, sweep_update, active_fn,
                   votes=None):
    """One stage of a cascade stepped on the host, as one while_loop of the
    reference: vote (active_fn), stop once at most `threshold` blocks are
    active, else sweep (sweep_update) and k += 1. One host read a vote (the
    active blocks' count). votes, if given, gains each vote's active count.
    Returns (carry, k, act) at the final k."""
    cur = list(carry)
    while True:
        act = active_fn(k, blocks, cur)
        idx = torch.nonzero(act).squeeze(1)
        sync.note()
        if votes is not None:
            votes.append(idx.numel())
        if idx.numel() <= threshold:
            return cur, k, act
        cur = list(sweep_update(k, blocks, cur, idx))
        k += 1


def _cascade_traverse(block_arrays, carry, sweep_update, active_fn,
                      min_blocks: int = 32):
    """_cascade_stages with each stage's loop stepped on the host
    (_stepped_stage): the perray queries.

    sweep_update(k, blocks, carry, idx) -> carry, where idx [n] i64 are the
    active blocks of the slice; active_fn(k, blocks, carry) -> [size] bool.
    One host read a vote (the active blocks' count); k stays on the host.
    Returns (carry, blk_index) as _cascade_stages does."""
    k_host = [0]

    def stage(blocks, carry_sl, k_dev, threshold):
        cur, k_host[0], act = _stepped_stage(blocks, carry_sl, k_host[0],
                                             threshold, sweep_update,
                                             active_fn)
        for dst, src in zip(carry_sl, cur):
            dst.copy_(src)
        return carry_sl, k_dev, act

    return _cascade_stages(block_arrays, carry, stage, min_blocks)


def _unpermute_blocks(arr, blk_index):
    """arr[i] holds the result for original block blk_index[i]; invert."""
    out = torch.empty_like(arr)
    out[blk_index] = arr
    return out


def pack_block_rays(o_blk, d_blk, tm_blk, t_min) -> torch.Tensor:
    """[B, R, 3] x2 + [B, R] -> [B, 8, R] tile-sweep ray pack."""
    tmin = torch.full_like(tm_blk, float(t_min))
    return torch.cat([o_blk.transpose(1, 2), d_blk.transpose(1, 2),
                      tm_blk[:, None], tmin[:, None]], dim=1).contiguous()


def any_hit_packets(accel: ClusterAccel, origins, directions, t_min, t_max,
                    block_size: int = 256, sort: bool = True,
                    group_size: int = 8, tri_pack=None,
                    exact_cull: int = 0,
                    sort_mode: str = "dir") -> torch.Tensor:
    """Occlusion query over a wave ([N] bool); N must be a multiple of
    block_size. Exact: a ray is occluded iff some triangle passes its
    Möller–Trumbore test within [t_min, t_max]. exact_cull=K culls with
    _exact_block_candidates (super shortlist cap K) in place of the
    conservative interval cull: fewer candidates a block, the same
    result. sort_mode: the coherence sort's key (_sort_keys' modes), used
    when sort is on."""
    n = origins.shape[0]
    if n % block_size:
        raise ValueError(f"wave size {n} not a multiple of {block_size}")
    nb = n // block_size
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    perm = None
    if sort:
        origins, directions, t_max, perm = _sort_rays(
            accel, origins, directions, t_max, sort_mode)

    o_blk = origins.reshape(nb, block_size, 3)
    d_blk = directions.reshape(nb, block_size, 3)
    tmax_blk = t_max.reshape(nb, block_size)

    if exact_cull:
        # a sorted wave is dead-last: its live blocks are a prefix
        order, n_cand, _entry = _exact_block_candidates(
            accel, o_blk, d_blk, tmax_blk, t_min, ksup=exact_cull,
            live_blocks=live_block_count(tmax_blk) if sort else None)
    else:
        order, n_cand, _entry = _block_candidates(accel, o_blk, d_blk,
                                                  tmax_blk)
    g = group_size
    c = accel.num_clusters
    c_pad = -(-c // g) * g
    if c_pad - c:
        order = torch.nn.functional.pad(order, (0, c_pad - c))
    order_g = order.reshape(nb, c_pad // g, g)
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    rays = pack_block_rays(o_blk, d_blk, tmax_blk, t_min)

    # a stage: the any-hit fold of cuda_cascade.cascade_stage (dead lanes,
    # t_max < 0, count as resolved; lanes occluded in an earlier iteration
    # go in dead)
    carry, blk_index = _cascade_stages(
        (rays, order_g, n_cand),
        (torch.zeros((nb, block_size), dtype=torch.bool, device=dev),),
        lambda b, c, k, thr: cuda_cascade.cascade_stage(
            tri_pack, b[0], b[1], b[2], c, k, thr))
    return _unsort(_unpermute_blocks(carry[0], blk_index).reshape(n), perm)


# Elements of each [rays, g * S] temporary of the perray queries' plain
# eager sweeps (256 MB in f32): the plain version's step only, its rows are
# swept this many at a time. On the card an iteration is one kernel launch.
# The results do not depend on the step.
PACKET_SWEEP_ELEMS = 1 << 26


def _kernel_sweeps(dev) -> bool:
    """Whether the perray queries' sweeps on `dev` launch the kernels (a
    CUDA device) or run the plain eager sweeps below (the CPU)."""
    return dev.type == "cuda"


def _packet_sweep_closest(accel, ob, db, t_cap, cid, t_min):
    """Blocks of rays ob/db [n, R, 3] (window [t_min, t_cap [n, R]]) against
    the g * S triangles of their clusters cid [n, g], in eager torch
    (traverse._mt_sweep's arithmetic): returns (ct [n, R] min t, gid [n, R]
    the triangle id of the FIRST slot achieving it; on a miss, inf and the
    id of slot 0). The plain version of kslot_sweep's first-slot instance
    in the perray query, run on the CPU."""
    n = cid.shape[0]
    ray = [ob[:, :, None, k] for k in range(3)]
    ray += [db[:, :, None, k] for k in range(3)]
    tri = []
    for arr in (accel.v0, accel.e1, accel.e2):
        a = arr[cid].reshape(n, -1, 3)
        tri += [a[:, None, :, k] for k in range(3)]
    t, _ok = cuda_ctiles.mt_sweep_rows(*ray, *tri, t_min, t_cap[:, :, None])
    slot = torch.argmin(t, dim=-1, keepdim=True)  # first minimum, as argmin
    cti = accel.tri_id[cid].reshape(n, -1)
    return (torch.gather(t, 2, slot).squeeze(2),
            torch.gather(cti, 1, slot.squeeze(2)))


def _packet_sweep_any(accel, ob, db, tb, cid, t_min):
    """Blocks of rays ob/db [n, R, 3] (window [t_min, tb [n, R]]) against
    the g * S triangles of their clusters cid [n, g], in eager torch: [n, R]
    bool, some test passes. The plain version of the perray any-hit sweep,
    run on the CPU."""
    n = cid.shape[0]
    ray = [ob[:, :, None, k] for k in range(3)]
    ray += [db[:, :, None, k] for k in range(3)]
    tri = []
    for arr in (accel.v0, accel.e1, accel.e2):
        a = arr[cid].reshape(n, -1, 3)
        tri += [a[:, None, :, k] for k in range(3)]
    _t, ok = cuda_ctiles.mt_sweep_rows(*ray, *tri, t_min, tb[:, :, None])
    return ok.any(dim=-1)


def closest_hit_packets(accel: ClusterAccel, origins, directions, t_min,
                        t_max, block_size: int = 256, sort: bool = True,
                        group_size: int = 8, sort_mode: str = "dir",
                        tri_pack=None) -> PacketHit:
    """Closest hit via the packet cascade (traverse.py:760-874); exact up to
    its tie rule. N must be a multiple of block_size.

    Blocks walk their candidates in conservative-entry order, `group_size`
    clusters an iteration, and retire once the next group's entry exceeds
    every live lane's best t. The tie rule is NOT the oracle's: within a
    group of g * S slots the FIRST slot at the minimum t wins (argmin), and
    a later group replaces the best only with a strictly smaller t. Each
    iteration sweeps, as the reference does, every block of the current
    slice that still has candidates (not only the active ones), with
    t_cap = min(t_max, best t). A stage is one call of
    cuda_cascade.cascade_stage's first-slot fold (on the card one launch of
    the stage kernel, T = block_size lanes; tri_pack as any_hit_packets').
    It runs in the overflow fallbacks and the opt-in "packets" backend."""
    n = origins.shape[0]
    if n % block_size:
        raise ValueError(f"wave size {n} not a multiple of {block_size}")
    nb = n // block_size
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    perm = None
    if sort:
        origins, directions, t_max, perm = _sort_rays(
            accel, origins, directions, t_max, sort_mode)
    o_blk = origins.reshape(nb, block_size, 3)
    d_blk = directions.reshape(nb, block_size, 3)
    tmax_blk = t_max.reshape(nb, block_size)

    order, n_cand, entry = _block_candidates(accel, o_blk, d_blk, tmax_blk)
    g = group_size
    c = accel.num_clusters
    c_pad = -(-c // g) * g
    if c_pad - c:
        order = torch.nn.functional.pad(order, (0, c_pad - c))
        entry = torch.nn.functional.pad(entry, (0, c_pad - c), value=INF)
    order_g = order.reshape(nb, c_pad // g, g)
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    rays = pack_block_rays(o_blk, d_blk, tmax_blk, t_min)

    carry, blk_index = _cascade_stages(
        (rays, order_g, n_cand, entry),
        (torch.full((nb, block_size), INF, dtype=torch.float32, device=dev),
         torch.full((nb, block_size), -1, dtype=torch.int32, device=dev)),
        lambda b, c_, k, thr: cuda_cascade.cascade_stage(
            tri_pack, b[0], b[1], b[2], c_, k, thr, entry=b[3]))
    t_out = _unsort(_unpermute_blocks(carry[0], blk_index).reshape(n), perm)
    id_out = _unsort(_unpermute_blocks(carry[1], blk_index).reshape(n), perm)
    return PacketHit(hit=torch.isfinite(t_out), t=t_out, tri=id_out)


# --- per-ray candidate lists: the perray queries (traverse.py:530-760) ------

def _perray_candidates(accel: ClusterAccel, origins, directions, t_min, t_max,
                       cap: int, row_chunk: int = 1 << 14,
                       order_mode: str = "id"):
    """Exact per-ray candidate clusters, capped at `cap` per ray: every ray
    gets its own inclusive slab test against all C cluster AABBs (the
    comparison-select form: a 0 * inf NaN keeps the running bound), rows
    `row_chunk` at a time.

    order_mode "id": ascending cluster ids (cumsum + searchsorted; slots
    past the count hold C - 1), entry 0; "entry": front to back by slab
    entry (a stable argsort; past the count, the non-candidates in id
    order), entry the entry t (inf past the count). Columns past C, where
    cap > C, hold 0 and entry inf.
    Returns (order [N, cap] i32, n_cand [N] i32 clipped to cap, entry
    [N, cap] f32, overflow [N] bool: more than cap candidates)."""
    n = origins.shape[0]
    c = accel.num_clusters
    dev = origins.device
    kx = min(cap, c)
    order = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    entry = torch.full((n, cap), INF, dtype=torch.float32, device=dev)
    n_cand = torch.zeros((n,), dtype=torch.int32, device=dev)
    targets = torch.arange(1, kx + 1, dtype=torch.int32, device=dev)
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        oc, dc, tc = origins[lo:hi], directions[lo:hi], t_max[lo:hi]
        inv = 1.0 / dc
        t0 = (accel.bmin[None] - oc[:, None, :]) * inv[:, None, :]
        t1 = (accel.bmax[None] - oc[:, None, :]) * inv[:, None, :]
        neg = inv[:, None, :] < 0.0
        near = torch.where(neg, t1, t0)
        far = torch.where(neg, t0, t1)
        lo_t = torch.full(near.shape[:2], float(t_min), dtype=torch.float32,
                          device=dev)
        hi_t = torch.minimum(tc[:, None].expand(near.shape[:2]),
                             torch.full((), INF, device=dev))
        for a in range(3):
            lo_t = torch.where(near[..., a] > lo_t, near[..., a], lo_t)
            hi_t = torch.where(far[..., a] < hi_t, far[..., a], hi_t)
        cand = hi_t >= lo_t                                   # [r, C]
        n_cand[lo:hi] = cand.sum(dim=1).to(torch.int32)
        if order_mode == "entry":
            ent = torch.where(cand, lo_t, INF)
            ok = torch.argsort(ent, dim=1, stable=True)[:, :kx]
            order[lo:hi, :kx] = ok.to(torch.int32)
            entry[lo:hi, :kx] = torch.gather(ent, 1, ok)
        else:
            cums = torch.cumsum(cand.to(torch.int32), dim=1)
            ok = torch.searchsorted(cums, targets.expand(hi - lo, kx).contiguous())
            order[lo:hi, :kx] = torch.clamp(ok, max=c - 1).to(torch.int32)
            entry[lo:hi, :kx] = 0.0
    return order, torch.clamp(n_cand, max=cap), entry, n_cand > cap


def _perray_setup(accel, origins, directions, t_min, t_max, cap, group_size):
    """The perray queries' common part: per-ray candidates (overflow rays
    get none), grouped [N, ceil(cap / g), g], and the one-ray blocks."""
    n = origins.shape[0]
    order, n_cand, _entry, overflow = _perray_candidates(
        accel, origins, directions, t_min, t_max, cap)
    n_cand = torch.where(overflow, 0, n_cand)
    g = group_size
    cap_pad = -(-cap // g) * g
    if cap_pad - cap:
        order = torch.nn.functional.pad(order, (0, cap_pad - cap))
    order_g = order.reshape(n, cap_pad // g, g)
    return (origins[:, None, :], directions[:, None, :], t_max[:, None],
            n_cand, order_g), overflow, cap_pad // g - 1


def _perray_fallback(origins, directions, t_max, overflow, block, run):
    """run(o, d, t_max) over the wave padded to `block` rays, rays that did
    not overflow going in dead; nothing when no ray overflowed."""
    if sync.host_int(overflow.sum()) == 0:
        return None
    n = origins.shape[0]
    pad = (-n) % block
    fo = torch.nn.functional.pad(origins, (0, 0, 0, pad))
    fd = torch.nn.functional.pad(directions, (0, 0, 0, pad), value=1.0)
    ftm = torch.nn.functional.pad(torch.where(overflow, t_max, -1.0),
                                  (0, pad), value=-1.0)
    return run(fo, fd, ftm)


def _perray_sweeps(accel, n, group_size, tri_pack, dev):
    """(rows a step, tri_pack, n_slots) of a perray query: on the card one
    kslot_sweep launch an iteration over the active rays, each against its
    g clusters (n_slots = g for every ray: the reference sweeps the whole
    group, the filler ids past the count too); on the CPU the plain eager
    sweeps, PACKET_SWEEP_ELEMS elements a step (tri_pack None)."""
    if not _kernel_sweeps(dev):
        return (max(1, PACKET_SWEEP_ELEMS
                    // (group_size * accel.cluster_size)), None, None)
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    n_slots = torch.full((n,), group_size, dtype=torch.int32, device=dev)
    return n, tri_pack, n_slots


def _perray_rays(ob, db, tb, t_min):
    """[n, 8] kslot_sweep ray rows of one-ray blocks ob/db [n, 1, 3] with
    window [t_min, tb [n, 1]]."""
    return cuda_kslots.pack_rays(ob[:, 0], db[:, 0], tb[:, 0], t_min)


def closest_hit_perray(accel: ClusterAccel, origins, directions, t_min,
                       t_max, cap: int = 64, group_size: int = 4,
                       fallback_block: int = 64,
                       tri_pack=None) -> PacketHit:
    """Closest hit with exact per-ray candidate lists (no ray blocking):
    the packet cascade's machinery with blocks of one ray, `group_size`
    candidates an iteration in id order, t_cap = min(t_max, best t). The
    tie rule is the packet cascade's: within a group of g * S slots the
    first slot at the minimum t wins, and a later group replaces the best
    only with a strictly smaller t. On the card an iteration's sweep is one
    launch of kslot_sweep's first-slot instance (tri_pack: pack_tris'), on
    the CPU the plain eager sweep (the reference's is XLA code). Rays with
    more than `cap` candidates complete through closest_hit_packets
    (blocks of fallback_block), so every ray is exact."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    blocks, overflow, max_k = _perray_setup(accel, origins, directions,
                                            t_min, t_max, cap, group_size)
    g = group_size
    rows, tri_pack, n_slots = _perray_sweeps(accel, n, g, tri_pack, dev)

    def active_fn(k, blocks, carry):
        # id-ordered candidates: only exhaustion and dead rays stop a ray
        tb, nc = blocks[2], blocks[3]
        return (k * g < nc) & (tb[:, 0] >= 0.0)

    def sweep_update(k, blocks, carry, idx):
        ob, db, tb, _nc, ordg = blocks
        best_t, best_id = (a.clone() for a in carry)
        for lo in range(0, idx.numel(), rows):
            sel = idx[lo:lo + rows]
            bt = best_t[sel]
            cap_t = torch.minimum(tb[sel], bt)
            cid = ordg[sel, min(k, max_k)]
            if tri_pack is not None:
                ct, gid = cuda_kslots.kslot_sweep(
                    tri_pack, _perray_rays(ob[sel], db[sel], cap_t, t_min),
                    cid, n_slots[:sel.numel()], True, tie="slot")
                ct, gid = ct[:, None], gid[:, None]
            else:
                ct, gid = _packet_sweep_closest(accel, ob[sel], db[sel],
                                                cap_t, cid, t_min)
            closer = ct < bt
            best_t[sel] = torch.where(closer, ct, bt)
            best_id[sel] = torch.where(closer, gid, best_id[sel])
        return best_t, best_id

    carry, blk_index = _cascade_traverse(
        blocks,
        (torch.full((n, 1), INF, dtype=torch.float32, device=dev),
         torch.full((n, 1), -1, dtype=torch.int32, device=dev)),
        sweep_update, active_fn, min_blocks=1024)
    best_t = _unpermute_blocks(carry[0], blk_index)[:, 0]
    best_id = _unpermute_blocks(carry[1], blk_index)[:, 0]

    fb = _perray_fallback(
        origins, directions, t_max, overflow, fallback_block,
        lambda o, d, tm: closest_hit_packets(accel, o, d, t_min, tm,
                                             block_size=fallback_block,
                                             tri_pack=tri_pack))
    if fb is not None:
        best_t = torch.where(overflow, fb.t[:n], best_t)
        best_id = torch.where(overflow, fb.tri[:n], best_id)
    return PacketHit(hit=torch.isfinite(best_t), t=best_t, tri=best_id)


def any_hit_perray(accel: ClusterAccel, origins, directions, t_min, t_max,
                   cap: int = 64, group_size: int = 4,
                   fallback_block: int = 64, tri_pack=None) -> torch.Tensor:
    """Occlusion with exact per-ray candidate lists ([N] bool); a ray
    leaves the cascade once occluded. On the card an iteration's sweep is
    one launch of kslot_sweep's any-hit sweep (each active ray against its
    g clusters), on the CPU the plain eager sweep. Rays with more than
    `cap` candidates complete through any_hit_packets (blocks of
    fallback_block; tri_pack as its)."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    blocks, overflow, max_k = _perray_setup(accel, origins, directions,
                                            t_min, t_max, cap, group_size)
    g = group_size
    rows, pack, n_slots = _perray_sweeps(accel, n, g, tri_pack, dev)

    def active_fn(k, blocks, carry):
        return (k * g < blocks[3]) & ~carry[0][:, 0]

    def sweep_update(k, blocks, carry, idx):
        ob, db, tb, _nc, ordg = blocks
        occ = carry[0].clone()
        for lo in range(0, idx.numel(), rows):
            sel = idx[lo:lo + rows]
            cid = ordg[sel, min(k, max_k)]
            if pack is not None:
                (hit,) = cuda_kslots.kslot_sweep(
                    pack, _perray_rays(ob[sel], db[sel], tb[sel], t_min), cid,
                    n_slots[:sel.numel()], False)
                occ[sel] |= hit[:, None]
            else:
                occ[sel] |= _packet_sweep_any(accel, ob[sel], db[sel],
                                              tb[sel], cid, t_min)
        return (occ,)

    carry, blk_index = _cascade_traverse(
        blocks, (torch.zeros((n, 1), dtype=torch.bool, device=dev),),
        sweep_update, active_fn, min_blocks=1024)
    occluded = _unpermute_blocks(carry[0], blk_index)[:, 0]

    fb = _perray_fallback(
        origins, directions, t_max, overflow, fallback_block,
        lambda o, d, tm: any_hit_packets(accel, o, d, t_min, tm,
                                         block_size=fallback_block,
                                         tri_pack=tri_pack))
    if fb is None:
        return occluded
    return torch.where(overflow, fb[:n], occluded)
