"""Cluster-major tile traversal (counterpart of accel/ctiles.py).

1. SORT      — rays sorted (`sort_mode`, "octorig" by default: octant and
               fine origin Morton) into blocks of `block` rays, dead rays
               last.
2. CULL      — per-ray inclusive slab tests, OR'd per block: the true
               union of the per-ray candidate sets. levels=1 tests every
               cluster AABB (`_ray_masks` and `_extract_order_flat`);
               levels=2 tests the supercluster boxes first and then only
               the children of the block's super shortlist
               (`_block_candidates_2level`); levels=0 picks 2 past 2048
               clusters, as the reference does. On the card either is one
               launch of accel.cuda_ctiles.block_cull.
3. PAIRS     — flat (block, candidate) pair domain, p = block*cap + k,
               sorted by cluster id and padded per cluster to whole tiles of
               `tile_blocks` blocks (T = tile_blocks*block rays share one
               cluster), into slot tables of a static size. pair_split=H
               sorts only the head columns k < H of every block plus the
               tail columns of at most nb // 8 blocks.
4. SWEEP     — accel.cuda_ctiles.slot_sweep: tile_sweep's body over the
               static slot tables up to the live tile count; `sub_skip` /
               `pallas_pack_t` select its two options.
5. RESOLVE   — folded into the sweep: per-block (t, tri), best t first,
               then the minimum tri id among slots achieving it (the
               oracle's lexicographic tie rule); for occlusion, tri !=
               INT32_MAX per slot, OR'd per block.

On the card a call reads nothing from the device but the overflow
fallback's counts: the live-block count (the reference's traced
`live_blocks`) and the live tile count (its dynamic `n_chunks`) stay on
the card, read by the two kernels.

Blocks whose union exceeds `cap` (or `super_cap` supers, or the split
tail budget) complete exactly through the overflow fallback
(worklist._overflow_fallback: per-ray pair tiles on a compacted wave of at
most `fallback_compact` rays, else the packet cascade on the whole wave),
in the sorted domain before the unsort (fallback_sorted=True) or on the
unsorted wave after it. The reference pads each cluster's tile list to
runs of 8 tiles for its Pallas grid; the CUDA kernel reads one cluster id
per tile, so here the padding is per tile. Results do not depend on the
padding.
"""

from __future__ import annotations

from functools import partial

import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.kslots import _ray_slab
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.accel.worklist import (
    _extract_k,
    _overflow_fallback,
    _prepare_blocks,
    _unsort,
)

INF = float("inf")
NEG_BIG = -(2**30)  # the reference's empty top_k slot; negated: 2**30


def _chunk_end(nb, row_chunk, live_blocks):
    """Rows the cull computes: all of them, or the whole row chunks that
    cover the live-block prefix (the reference's fori_loop bound)."""
    if live_blocks is None:
        return nb
    return min(nb, -(-live_blocks // row_chunk) * row_chunk)


def _ray_masks(accel, o_blk, d_blk, tm_blk, t_min, row_chunk, live_blocks=None):
    """Per-ray exact cull -> per-block OR'd candidate sets.

    Returns (cand [nb, C] bool, n_cand [nb] i32). Dead rays contribute
    nothing. live_blocks (valid only for waves sorted dead-last) bounds
    the chunks that are computed; later blocks keep empty sets."""
    nb, b = o_blk.shape[:2]
    c = accel.num_clusters
    cand = torch.zeros((nb, c), dtype=torch.bool, device=o_blk.device)
    for lo in range(0, _chunk_end(nb, row_chunk, live_blocks), row_chunk):
        hi = min(lo + row_chunk, nb)
        of = o_blk[lo:hi].reshape(-1, 3)
        df = d_blk[lo:hi].reshape(-1, 3)
        tf = tm_blk[lo:hi].reshape(-1)
        lo0 = torch.full_like(tf, float(t_min))
        hi0 = torch.where(tf >= 0.0, tf, -INF)
        rc = _ray_slab(accel.bmin, accel.bmax, of, df, lo0, hi0)
        cand[lo:hi] = rc.reshape(hi - lo, b, c).any(dim=1)
    return cand, cand.sum(dim=1).to(torch.int32)


def _extract_order_flat(accel, cand, n_cand, cap, row_chunk=1 << 11):
    """Per-block candidate ids, ascending -> (order [nb, kx], n_cand, over).
    Overflow blocks (n_cand > cap) get n_cand 0; slots past n_cand hold
    C-1."""
    c = accel.num_clusters
    over = n_cand > cap
    n_cand = torch.where(over, 0, n_cand)
    kx = min(cap, c)
    masked = cand & ~over[:, None]
    order = torch.cat([
        _extract_k(masked[lo:lo + row_chunk], kx, c - 1)
        for lo in range(0, cand.shape[0], row_chunk)
    ]) if cand.shape[0] else torch.zeros((0, kx), dtype=torch.int32,
                                         device=cand.device)
    return order, n_cand, over


def _block_candidates_2level(accel, o_blk, d_blk, tm_blk, t_min, cap,
                             row_chunk, super_cap, live_blocks=None):
    """Hierarchical per-ray cull (ctiles.py:194-344): the supercluster
    shortlist of each block (the OR of its rays' super slab tests, at most
    super_cap supers, else the block overflows), then each ray's slab test
    against the shortlist's child boxes only, OR'd per block.

    Child ids come out ascending (supers ascend, children within a super
    ascend). The child test is the sign-select near/far in where form, so
    the inverted boxes of a partly filled last super fail (min/max would
    pass them). Blocks with more than min(cap, super_cap * super_size, C)
    candidates overflow. Returns (order [nb, kx] i32, n_cand [nb] i32, 0
    on overflow, over [nb] bool); as in the reference, slots past n_cand
    hold C-1, and rows past the computed chunks (live_blocks) hold 0."""
    nb, b = o_blk.shape[:2]
    dev = o_blk.device
    c = accel.num_clusters
    cs = accel.num_supers
    ss = accel.super_size
    scap = min(super_cap, cs)
    k_child = scap * ss
    kx = min(cap, k_child, c)
    order = torch.zeros((nb, kx), dtype=torch.int32, device=dev)
    n_cand = torch.zeros((nb,), dtype=torch.int32, device=dev)
    over = torch.zeros((nb,), dtype=torch.bool, device=dev)
    j = torch.arange(ss, dtype=torch.int64, device=dev)
    for lo in range(0, _chunk_end(nb, row_chunk, live_blocks), row_chunk):
        hi = min(lo + row_chunk, nb)
        rc = hi - lo
        oc, dc, tc = o_blk[lo:hi], d_blk[lo:hi], tm_blk[lo:hi]
        tf = tc.reshape(-1)
        lo0 = torch.full_like(tf, float(t_min))
        hi0 = torch.where(tf >= 0.0, tf, -INF)

        # Level 1: per-ray super slab -> per-block OR -> shortlist.
        cand_s = _ray_slab(accel.sbmin, accel.sbmax, oc.reshape(-1, 3),
                           dc.reshape(-1, 3), lo0, hi0)
        cand_sb = cand_s.reshape(rc, b, cs).any(dim=1)          # [rc, Cs]
        ov = cand_sb.sum(dim=1) > scap
        sup = _extract_k(cand_sb & ~ov[:, None], scap, -NEG_BIG).long()
        sup_live = sup < cs
        sup_c = torch.clamp(sup, 0, cs - 1)

        # Level 2: per-ray slab vs the block's gathered child boxes.
        cbmin = accel.cbmin[sup_c].reshape(rc, k_child, 3)
        cbmax = accel.cbmax[sup_c].reshape(rc, k_child, 3)
        inv = 1.0 / dc                                          # [rc, b, 3]
        lo_t = torch.full((rc, b, k_child), float(t_min), dtype=torch.float32,
                          device=dev)
        hi_t = torch.where(tc >= 0.0, tc, -INF)[..., None].expand(
            rc, b, k_child)
        for a in range(3):
            inv_a = inv[:, :, None, a]
            t0 = (cbmin[:, None, :, a] - oc[:, :, None, a]) * inv_a
            t1 = (cbmax[:, None, :, a] - oc[:, :, None, a]) * inv_a
            neg = inv_a < 0.0
            near = torch.where(neg, t1, t0)
            far = torch.where(neg, t0, t1)
            lo_t = torch.where(near > lo_t, near, lo_t)
            hi_t = torch.where(far < hi_t, far, hi_t)
        cand_k = (hi_t >= lo_t).any(dim=1)                      # [rc, K]
        cand_k &= sup_live.repeat_interleave(ss, dim=1)
        cand_k &= ~ov[:, None]

        child_id = (sup_c[:, :, None] * ss + j).reshape(rc, k_child)
        nc = cand_k.sum(dim=1).to(torch.int32)
        ov = ov | (nc > kx)
        cand_k &= ~ov[:, None]
        cols = _extract_k(cand_k, kx, k_child).long()
        child_id = torch.nn.functional.pad(child_id, (0, 1), value=c - 1)
        order[lo:hi] = torch.clamp(torch.gather(child_id, 1, cols),
                                   max=c - 1).to(torch.int32)
        n_cand[lo:hi] = torch.where(ov, 0, nc)
        over[lo:hi] = ov
    return order, n_cand, over


def _build_pairs(accel, order, n_cand, over, cap, tile_blocks, split_head=0,
                 split_tail_den=8):
    """Candidate tables -> cluster-major slots padded to whole tiles.

    Pair p = block*cap + k (k-th candidate of its block), so its owner is
    p // cap. One sort by cluster id gives the cluster-major order; it is
    stable, as the reference's lax.sort, so the tables are the reference's
    (the results would not change with another order inside a cluster: the
    resolve is a lexicographic min).

    split_head=H (0 < H < cap): only the head columns k < H of every block
    are sorted, plus the tail columns of the blocks with more than H
    candidates, compacted in block order into nb // split_tail_den rows;
    tail blocks past that budget overflow (ctiles.py:374-419).

    The slot tables have the reference's static size at tile_group=1,
    ni_pad = n_pairs + tile_blocks * C rounded up to whole tiles (each
    cluster pads at most tile_blocks - 1 slots); the live count stays on
    the device, and the scatters drop what lies past the live prefix.

    Returns dict(overflow [nb], slot_pair [ni_pad] i32 flat pair id or -1
    for padding, slot_cid [ni_pad] i32 (C - 1 past the live slots; the
    reference's carries its last run's id), n_slots and n_tiles: 0-dim device
    tensors, the live slots and n_slots // tile_blocks as i32)."""
    nb = order.shape[0]
    c = accel.num_clusters
    tb = tile_blocks
    dev = order.device
    if cap > order.shape[1]:
        order = torch.nn.functional.pad(order, (0, cap - order.shape[1]),
                                        value=c - 1)
    if split_head and split_head < cap:
        h = split_head
        tb_cap = max(1, nb // split_tail_den)
        is_tail = n_cand > h
        tail_rank = torch.cumsum(is_tail.to(torch.int32), 0)     # inclusive
        over_budget = is_tail & (tail_rank > tb_cap)
        over = over | over_budget
        n_cand = torch.where(over_budget, 0, n_cand)
        kidx = torch.arange(h, device=dev)[None, :]
        key_h = torch.where(kidx < n_cand[:, None], order[:, :h],
                            c).reshape(-1)
        pid_h = (torch.arange(nb, device=dev)[:, None] * cap
                 + kidx).reshape(-1)
        # the tail blocks, compacted in block order
        tpos = torch.where(is_tail & ~over_budget, tail_rank - 1,
                           tb_cap).long()
        tail_blk = torch.full((tb_cap + 1,), nb, dtype=torch.int64,
                              device=dev)
        tail_blk[tpos] = torch.arange(nb, device=dev)
        tail_blk = tail_blk[:tb_cap]
        tbi = torch.clamp(tail_blk, max=nb - 1)
        kt = h + torch.arange(cap - h, device=dev)[None, :]
        livek_t = (tail_blk < nb)[:, None] & (kt < n_cand[tbi][:, None])
        key_t = torch.where(livek_t, order[tbi, h:cap], c).reshape(-1)
        pid_t = (tbi[:, None] * cap + kt).reshape(-1)
        key = torch.cat([key_h, key_t.to(key_h.dtype)])
        key_sorted, idx = torch.sort(key, stable=True)
        perm = torch.cat([pid_h, pid_t])[idx]
    else:
        livek = torch.arange(cap, device=dev)[None, :] < n_cand[:, None]
        key = torch.where(livek, order, c).reshape(-1)        # [nb*cap]
        key_sorted, perm = torch.sort(key, stable=True)
    n_pairs = key_sorted.shape[0]
    ni_pad = -(-(n_pairs + tb * c) // tb) * tb
    base = torch.searchsorted(
        key_sorted, torch.arange(c + 1, dtype=key_sorted.dtype, device=dev))
    counts = base[1:] - base[:-1]                             # [c]
    pcounts = (-(-counts // tb)) * tb
    pend = torch.cumsum(pcounts, 0)                           # [c]
    pbase = pend - pcounts
    n_slots = pcounts.sum()                                   # on the device

    # slot_cid: cluster of each slot, the runs whose ends lie at or before
    # it (the reference's cummax of each run's start; a scan with indices
    # over the static size would cost ten times the rest of the build).
    # Slots past the live ones name cluster C - 1.
    slot_cid = torch.clamp(torch.searchsorted(
        pend, torch.arange(ni_pad, dtype=pend.dtype, device=dev),
        right=True), max=c - 1).to(torch.int32)

    # slot_pair: flat pair id per slot, -1 on padding (dead keys sort last).
    n_live = base[c]
    q = torch.arange(n_pairs, device=dev)
    kc = torch.clamp(key_sorted, max=c - 1)
    pos = torch.where(q < n_live, pbase[kc] + (q - base[kc]), ni_pad)
    slot_pair = torch.full((ni_pad + 1,), -1, dtype=torch.int32, device=dev)
    slot_pair[pos] = perm.to(torch.int32)
    return dict(overflow=over, slot_pair=slot_pair[:ni_pad],
                slot_cid=slot_cid, n_slots=n_slots,
                n_tiles=(n_slots // tb).to(torch.int32))


def sweep_pack_builder(sub_skip: bool = False, pallas_pack_t: bool = False):
    """The builder of the pack tile_sweep reads with these options:
    pack_tris (neither), pack_tris16 (sub_skip) or pack_tris16_t (its
    [C, S, 16] transpose, pallas_pack_t)."""
    if sub_skip:
        return cuda_ctiles.pack_tris16
    if pallas_pack_t:
        return cuda_ctiles.pack_tris16_t
    return cuda_ctiles.pack_tris


def _sweep_resolve(accel, pairs, o_blk, d_blk, tm_blk, t_min, cap,
                   tile_blocks, tile_chunk, want_tri, pack, sub_skip=False,
                   pack_t=False):
    """Tile sweep over the cluster-major slots with the per-block resolve
    folded in (cuda_ctiles.slot_sweep, every live tile in one launch; on
    the CPU its plain version, in chunks of tile_chunk tiles).

    Returns (t_blk [nb, b], tri_blk [nb, b]) with (inf, INT32_MAX) where a
    ray found nothing, or with want_tri=False (occ_blk [nb, b],): a slot
    occludes where its tri != INT32_MAX (any passing test sets it), OR'd
    per block."""
    nb, b = o_blk.shape[:2]
    dev = o_blk.device
    # Block-row ray table [nb+1, 8, b]; row nb is the dead block that
    # padding slots read (o 0, d 1, t_max -1: every test fails).
    tmin_row = torch.full((nb, 1, b), float(t_min), dtype=torch.float32,
                          device=dev)
    dead = torch.cat([
        torch.zeros((1, 3, b), dtype=torch.float32, device=dev),
        torch.ones((1, 3, b), dtype=torch.float32, device=dev),
        torch.full((1, 1, b), -1.0, dtype=torch.float32, device=dev),
        tmin_row[:1],
    ], dim=1)
    ray_blocks = torch.cat([
        torch.cat([o_blk.transpose(1, 2), d_blk.transpose(1, 2),
                   tm_blk[:, None, :], tmin_row], dim=1),
        dead,
    ], dim=0)
    sweep = cuda_ctiles.slot_sweep
    if dev.type == "cpu":
        sweep = partial(cuda_ctiles.slot_sweep_plain, tile_chunk=tile_chunk)
    return sweep(
        pack, ray_blocks, pairs["slot_pair"], pairs["slot_cid"],
        pairs["n_tiles"], tile_slots=tile_blocks, cap=cap,
        out="closest" if want_tri else "any", cid_stride=tile_blocks,
        sub_skip=sub_skip, pack_t=pack_t)


def _run(accel, origins, directions, t_min, t_max, *, block, cap,
         tile_blocks, row_chunk, tile_chunk, sort, sort_mode, fallback_block,
         fallback_compact, want_tri, levels, super_cap, sub_skip,
         fallback_sorted, pair_split, pallas_pack_t, tri_pack, sweep_pack):
    if sub_skip and pallas_pack_t:
        raise ValueError("sub_skip reads the [C, 16, S] pack; pallas_pack_t "
                         "cannot be combined with it")
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    if sweep_pack is None:
        build = sweep_pack_builder(sub_skip, pallas_pack_t)
        sweep_pack = (tri_pack if build is cuda_ctiles.pack_tris
                      else build(accel))
    o_blk, d_blk, tm_blk, perm, npad = _prepare_blocks(
        accel, origins, directions, t_max, block, sort, sort_mode)
    nb = o_blk.shape[0]
    live_blocks = None
    if sort:  # sorted waves put dead rays last: cull only the live prefix
        n_live = (t_max >= 0.0).sum()
        live_blocks = ((n_live + block - 1) // block).to(torch.int32)
    if levels == 0:
        levels = 2 if accel.num_clusters > 2048 else 1
    if dev.type == "cpu":  # the plain version, in the caller's chunks
        order, n_cand, over = cuda_ctiles.block_cull_plain(
            accel, o_blk, d_blk, tm_blk, t_min, cap, live_blocks,
            row_chunk=row_chunk, levels=levels, super_cap=super_cap)
    else:
        order, n_cand, over = cuda_ctiles.block_cull(
            accel, o_blk, d_blk, tm_blk, t_min, cap, live_blocks,
            levels=levels, super_cap=super_cap)
    pairs = _build_pairs(accel, order, n_cand, over, cap, tile_blocks,
                         split_head=pair_split)
    blk_res = _sweep_resolve(accel, pairs, o_blk, d_blk, tm_blk, t_min, cap,
                             tile_blocks, tile_chunk, want_tri, sweep_pack,
                             sub_skip=sub_skip, pack_t=pallas_pack_t)
    over_blk = pairs["overflow"]
    over_s = over_blk[:, None].expand(-1, block).reshape(-1)
    fb_kw = dict(want_tri=want_tri, compact_cap=fallback_compact,
                 fallback_block=fallback_block, tri_pack=tri_pack,
                 over_blocks=over_blk.sum())
    if fallback_sorted:
        # Overflow completes in the sorted domain, before the unsort.
        fb = _overflow_fallback(
            accel, o_blk.reshape(npad, 3), d_blk.reshape(npad, 3), t_min,
            tm_blk.reshape(npad), over_s, **fb_kw)
        merged = tuple(torch.where(over_s, f, r.reshape(-1))
                       for f, r in zip(fb, blk_res))
        return _unsort(merged, perm, npad, n)
    # One unsort carries the results and the overflow column; the fallback
    # then runs on the unsorted wave.
    unsorted = _unsort(tuple(a.reshape(-1) for a in blk_res) + (over_s,),
                       perm, npad, n)
    res_u, overflow_ray = unsorted[:-1], unsorted[-1]
    fb = _overflow_fallback(accel, origins, directions, t_min, t_max,
                            overflow_ray, **fb_kw)
    return tuple(torch.where(overflow_ray, f, r) for f, r in zip(fb, res_u))


def closest_hit_ctiles(accel, origins, directions, t_min, t_max,
                       block: int = 8, cap: int = 48, tile_blocks: int = 16,
                       row_chunk: int = 1 << 11, tile_chunk: int = 256,
                       sort: bool = True, sort_mode: str = "octorig",
                       fallback_block: int = 64,
                       fallback_compact: int = 1 << 13, levels: int = 0,
                       super_cap: int = 48, sub_skip: bool = False,
                       fallback_sorted: bool = False, pair_split: int = 0,
                       pallas_pack_t: bool = False, tri_pack=None,
                       sweep_pack=None) -> PacketHit:
    """Closest hit via cluster-major tiles; exact for every ray.

    tri_pack: cuda_ctiles.pack_tris(accel), which the overflow fallback
    reads (None builds it); sweep_pack: the pack the sweep reads with these
    options (sweep_pack_builder's; None builds it, or takes tri_pack).
    row_chunk and tile_chunk are the reference's chunk sizes: the CPU's
    plain versions run in them; on the card the cull and the sweep take
    none (each runs its live prefix in one launch)."""
    best_t, best_tri = _run(
        accel, origins, directions, t_min, t_max, block=block, cap=cap,
        tile_blocks=tile_blocks, row_chunk=row_chunk, tile_chunk=tile_chunk,
        sort=sort, sort_mode=sort_mode, fallback_block=fallback_block,
        fallback_compact=fallback_compact, want_tri=True, levels=levels,
        super_cap=super_cap, sub_skip=sub_skip,
        fallback_sorted=fallback_sorted, pair_split=pair_split,
        pallas_pack_t=pallas_pack_t, tri_pack=tri_pack,
        sweep_pack=sweep_pack)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t, tri=torch.where(hit, best_tri, -1))


def any_hit_ctiles(accel, origins, directions, t_min, t_max,
                   block: int = 8, cap: int = 48, tile_blocks: int = 16,
                   row_chunk: int = 1 << 11, tile_chunk: int = 256,
                   sort: bool = True, sort_mode: str = "octorig",
                   fallback_block: int = 64, fallback_compact: int = 1 << 13,
                   levels: int = 0, super_cap: int = 48,
                   sub_skip: bool = False, fallback_sorted: bool = False,
                   pair_split: int = 0, pallas_pack_t: bool = False,
                   tri_pack=None, sweep_pack=None) -> torch.Tensor:
    """Occlusion query via cluster-major tiles ([N] bool); exact for every
    ray. tri_pack / sweep_pack as closest_hit_ctiles'."""
    (occ,) = _run(
        accel, origins, directions, t_min, t_max, block=block, cap=cap,
        tile_blocks=tile_blocks, row_chunk=row_chunk, tile_chunk=tile_chunk,
        sort=sort, sort_mode=sort_mode, fallback_block=fallback_block,
        fallback_compact=fallback_compact, want_tri=False, levels=levels,
        super_cap=super_cap, sub_skip=sub_skip,
        fallback_sorted=fallback_sorted, pair_split=pair_split,
        pallas_pack_t=pallas_pack_t, tri_pack=tri_pack,
        sweep_pack=sweep_pack)
    return occ
