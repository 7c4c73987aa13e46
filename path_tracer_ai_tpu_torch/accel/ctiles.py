"""Cluster-major tile traversal: the closest-hit path of the wavefront engine.

Counterpart of accel/ctiles.py `closest_hit_ctiles` on the flat cull
(levels=1, which the reference picks up to 2048 clusters):

1. SORT      — rays sorted by (octant, fine origin Morton) into blocks of
               `block` rays, dead rays last.
2. CULL      — per-ray inclusive slab tests against all cluster AABBs,
               OR'd per block: the true union of the per-ray candidate sets.
3. PAIRS     — flat (block, candidate) pair domain, p = block*cap + k,
               sorted by cluster id and padded per cluster to whole tiles of
               `tile_blocks` blocks (T = tile_blocks*block rays share one
               cluster).
4. SWEEP     — the cluster-tile kernel (accel.cuda_ctiles.tile_sweep) over
               chunks of `tile_chunk` tiles.
5. RESOLVE   — per-block (t, tri) by row scatter-min: best t first, then
               the minimum tri id among slots achieving it (the oracle's
               lexicographic tie rule).

Blocks whose union exceeds `cap` complete exactly through the overflow
fallback (worklist._overflow_fallback), in the sorted domain, before the
unsort. The reference pads each cluster's tile list to runs of 8 tiles
for its Pallas grid; the CUDA kernel reads one cluster id per tile, so
here the padding is per tile. Results do not depend on the padding.
"""

from __future__ import annotations

import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.kslots import _ray_slab
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.accel.worklist import (
    I32_MAX,
    _extract_k,
    _overflow_fallback,
    _prepare_blocks,
    _unsort,
)
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
BLOCK = 8           # rays per block (sorted "octorig" neighbours)
TILE_BLOCKS = 16    # blocks per tile: T = 128 rays share one cluster
ROW_CHUNK = 1 << 11  # blocks per step of the cull ([16384, C, 3] temporaries)


def _ray_masks(accel, o_blk, d_blk, tm_blk, t_min, row_chunk, live_blocks=None):
    """Per-ray exact cull -> per-block OR'd candidate sets.

    Returns (cand [nb, C] bool, n_cand [nb] i32). Dead rays contribute
    nothing. live_blocks (valid only for waves sorted dead-last) bounds
    the chunks that are computed; later blocks keep empty sets."""
    nb, b = o_blk.shape[:2]
    c = accel.num_clusters
    cand = torch.zeros((nb, c), dtype=torch.bool, device=o_blk.device)
    end = nb if live_blocks is None else min(nb, live_blocks)
    for lo in range(0, end, row_chunk):
        hi = min(lo + row_chunk, nb)
        of = o_blk[lo:hi].reshape(-1, 3)
        df = d_blk[lo:hi].reshape(-1, 3)
        tf = tm_blk[lo:hi].reshape(-1)
        lo0 = torch.full_like(tf, float(t_min))
        hi0 = torch.where(tf >= 0.0, tf, -INF)
        rc = _ray_slab(accel.bmin, accel.bmax, of, df, lo0, hi0)
        cand[lo:hi] = rc.reshape(hi - lo, b, c).any(dim=1)
    return cand, cand.sum(dim=1).to(torch.int32)


def _extract_order_flat(accel, cand, n_cand, cap, row_chunk=ROW_CHUNK):
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


def _build_pairs(accel, order, n_cand, over, cap, tile_blocks):
    """Candidate tables -> cluster-major slots padded to whole tiles.

    Pair p = block*cap + k (k-th candidate of its block), so its owner is
    p // cap. One sort by cluster id (within-cluster order is free: the
    resolve is a lexicographic min) gives the cluster-major order.
    Returns dict(overflow [nb], slot_pair [n_slots] i32 flat pair id or -1
    for padding, slot_cid [n_slots] i32, n_slots int)."""
    nb = order.shape[0]
    c = accel.num_clusters
    tb = tile_blocks
    dev = order.device
    if cap > order.shape[1]:
        order = torch.nn.functional.pad(order, (0, cap - order.shape[1]),
                                        value=c - 1)
    livek = torch.arange(cap, device=dev)[None, :] < n_cand[:, None]
    key = torch.where(livek, order, c).reshape(-1)            # [nb*cap]
    key_sorted, perm = torch.sort(key)
    base = torch.searchsorted(
        key_sorted, torch.arange(c + 1, dtype=key_sorted.dtype, device=dev))
    counts = base[1:] - base[:-1]                             # [c]
    pcounts = (-(-counts // tb)) * tb
    pbase = torch.cumsum(pcounts, 0) - pcounts                # [c]
    n_slots = sync.host_int(pcounts.sum())

    # slot_cid: cluster of each slot (mark each non-empty run's start, cummax).
    mark = torch.where(pcounts > 0, pbase, n_slots)
    slot_cid = torch.zeros((n_slots + 1,), dtype=torch.int64, device=dev)
    slot_cid.scatter_reduce_(0, mark, torch.arange(c, device=dev), "amax")
    slot_cid = torch.cummax(slot_cid[:n_slots], 0).values.to(torch.int32)

    # slot_pair: flat pair id per slot, -1 on padding (dead keys sort last).
    n_live = base[c]
    q = torch.arange(key_sorted.shape[0], device=dev)
    kc = torch.clamp(key_sorted, max=c - 1)
    pos = torch.where(q < n_live, pbase[kc] + (q - base[kc]), n_slots)
    slot_pair = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    slot_pair[pos] = perm.to(torch.int32)
    return dict(overflow=over, slot_pair=slot_pair[:n_slots],
                slot_cid=slot_cid, n_slots=n_slots)


def _sweep_resolve(accel, pairs, o_blk, d_blk, tm_blk, t_min, cap,
                   tile_blocks, tile_chunk, tri_pack):
    """Tile sweep over the cluster-major slots, then the per-block resolve.

    Returns (t_blk [nb, b], tri_blk [nb, b]) with (inf, INT32_MAX) where a
    ray found nothing."""
    nb, b = o_blk.shape[:2]
    tb = tile_blocks
    dev = o_blk.device
    n_tiles = pairs["n_slots"] // tb
    slot_cid, slot_pair = pairs["slot_cid"], pairs["slot_pair"]

    # Block-row ray pack [nb+1, 8, b]; row nb is the dead block that
    # padding slots gather (o 0, d 1, t_max -1: every test fails).
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

    # Pass 1: per-slot (t, tri) from the kernel; per-block t by scatter-min.
    # Row nb of the block tables is a sink for padding slots.
    t_blk = torch.full((nb + 1, b), INF, dtype=torch.float32, device=dev)
    chunks = []
    for start in range(0, n_tiles, tile_chunk):
        stop = min(start + tile_chunk, n_tiles)
        tc = stop - start
        sp = slot_pair[start * tb:stop * tb]
        blk = torch.where(sp >= 0, sp // cap, nb).to(torch.int64)
        rays_pack = (ray_blocks[blk].reshape(tc, tb, 8, b).transpose(1, 2)
                     .reshape(tc, 8, tb * b).contiguous())
        cid = slot_cid[start * tb:stop * tb:tb].contiguous()
        ct, tri_min = cuda_ctiles.tile_sweep(tri_pack, rays_pack, cid)
        ct = ct.reshape(tc * tb, b)
        t_blk.scatter_reduce_(0, blk[:, None].expand(-1, b), ct, "amin")
        chunks.append((blk, ct, tri_min.reshape(tc * tb, b)))

    # Pass 2: the minimum tri id among slots achieving the block's best t.
    tri_blk = torch.full((nb + 1, b), I32_MAX, dtype=torch.int32, device=dev)
    for blk, ct, ctri in chunks:
        keep = ct <= t_blk[blk]
        tri_blk.scatter_reduce_(0, blk[:, None].expand(-1, b),
                                torch.where(keep, ctri, I32_MAX), "amin")
    return t_blk[:nb], tri_blk[:nb]


def closest_hit_ctiles(accel, origins, directions, t_min, t_max,
                       cap: int = 48, tile_chunk: int = 256, sort: bool = True,
                       fallback_compact: int = 1 << 13,
                       tri_pack=None) -> PacketHit:
    """Closest hit via cluster-major tiles; exact for every ray.

    Overflow completes in the sorted domain before the unsort (the
    reference's `fallback_sorted=True`, the only form ported)."""
    block, tile_blocks = BLOCK, TILE_BLOCKS
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    o_blk, d_blk, tm_blk, perm, npad = _prepare_blocks(
        accel, origins, directions, t_max, block, sort, "octorig")
    live_blocks = None
    if sort:  # sorted waves put dead rays last: cull only the live prefix
        n_live = sync.host_int((t_max >= 0.0).sum())
        live_blocks = -(-n_live // block)
    cand, n_cand = _ray_masks(accel, o_blk, d_blk, tm_blk, t_min, ROW_CHUNK,
                              live_blocks=live_blocks)
    order, n_cand, over = _extract_order_flat(accel, cand, n_cand, cap)
    pairs = _build_pairs(accel, order, n_cand, over, cap, tile_blocks)
    t_blk, tri_blk = _sweep_resolve(accel, pairs, o_blk, d_blk, tm_blk, t_min,
                                    cap, tile_blocks, tile_chunk, tri_pack)
    over_s = pairs["overflow"][:, None].expand(-1, block).reshape(-1)
    fb_t, fb_tri = _overflow_fallback(
        accel, o_blk.reshape(npad, 3), d_blk.reshape(npad, 3), t_min,
        tm_blk.reshape(npad), over_s, compact_cap=fallback_compact,
        tri_pack=tri_pack)
    best_t = torch.where(over_s, fb_t, t_blk.reshape(-1))
    best_tri = torch.where(over_s, fb_tri, tri_blk.reshape(-1))
    best_t, best_tri = _unsort((best_t, best_tri), perm, npad, n)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t, tri=torch.where(hit, best_tri, -1))
