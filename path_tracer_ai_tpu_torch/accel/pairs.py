"""Cluster-major pair-tile traversal: exact per-ray work, dense tiles.

Counterpart of accel/pairs.py (the whole module):

1. CULL    — every ray gets its own exact inclusive slab test against all
             cluster AABBs (`_ray_slab_chunk`, the reference's
             comparison-select form).
2. PACK    — the surviving (ray, cluster) pairs are packed cluster-major:
             each cluster owns a contiguous segment of pair slots padded to
             `tile_rays`; one permutation scatter builds the table.
3. SWEEP   — tiles of `tile_rays` pair lanes that share one cluster. A pair
             tile is exactly the cluster-tile kernel's unit: the pair table
             goes to ONE accel.cuda_ctiles.slot_sweep launch (per slot
             lane, T = tile_rays), which reads the tile count on the
             device, where the reference loops to a dynamic bound.
4. RESOLVE — each ray gathers its own pair slots, with the lexicographic
             (t, triangle id) rule of the brute-force oracle.

Rays whose candidates exceed `cap`, or whose pairs fall past the static
pair budget, complete through the packet cascades (`_overflow_fallback`),
whose closest-hit tie rule is the first slot's (traverse.closest_hit_packets).
The static sizes are the reference's, so the overflow sets are too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles, traverse
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

I32_MAX = cuda_ctiles.I32_MAX
INF = float("inf")
# Elements of each [rows, C] temporary of the cull: the rows of a chunk are
# culled this many at a time. The running per-cluster counts carry over, so
# the tables do not depend on the step.
CULL_ELEMS = 1 << 22

# This module's overflow completions since the last reset: calls that had
# overflow rays, those rays, and the calls that took the whole wave.
fallback_counts = {"calls": 0, "rays": 0, "whole_wave": 0}


def reset_fallback_counts() -> None:
    with sync.lock:
        for k in fallback_counts:
            fallback_counts[k] = 0


def _add_counts(**add) -> None:
    with sync.lock:  # the mesh's workers query from several threads
        for k, v in add.items():
            fallback_counts[k] += v


class PairTables(NamedTuple):
    """Pair scheduling tables for one wave (static shapes as the reference's)."""

    pair_ray: torch.Tensor      # [P] i32 ray id per pair slot (-1 = padding)
    tile_cluster: torch.Tensor  # [P // T] i32 cluster id per tile
    dst: torch.Tensor           # [N, cap] i32 pair slot of candidate k (P if none)
    n_cand: torch.Tensor        # [N] i32 candidates per ray (0 for overflow rays)
    overflow: torch.Tensor      # [N] bool ray needs the packet fallback
    n_tiles: torch.Tensor       # [] i32 real tile count


def _ray_slab_chunk(accel: ClusterAccel, oc, dc, tc, t_min):
    """Exact inclusive slab test of rays oc/dc [R, 3] (t_max tc [R],
    negative = dead) vs all cluster AABBs -> cand [R, C] bool.

    The reference's comparison-select form, kept apart from kslots._ray_slab:
    there a NaN (0 * inf) near/far bound is replaced by the axis' identity
    bound, here a NaN comparison keeps the running bound. Both keep the ray
    in, but they are written differently, so each module keeps its own."""
    inv = 1.0 / dc
    t0 = (accel.bmin[None] - oc[:, None, :]) * inv[:, None, :]
    t1 = (accel.bmax[None] - oc[:, None, :]) * inv[:, None, :]
    neg = inv[:, None, :] < 0.0
    near = torch.where(neg, t1, t0)
    far = torch.where(neg, t0, t1)
    lo = torch.full(near.shape[:2], float(t_min), dtype=torch.float32,
                    device=oc.device)
    hi = torch.minimum(tc[:, None].expand(near.shape[:2]),
                       torch.full((), INF, device=oc.device))
    for a in range(3):
        lo = torch.where(near[..., a] > lo, near[..., a], lo)
        hi = torch.where(far[..., a] < hi, far[..., a], hi)
    return (hi >= lo) & (tc >= 0.0)[:, None]


def build_pair_tables(accel: ClusterAccel, origins, directions, t_min, t_max,
                      cap: int = 32, pair_budget: int = 8,
                      tile_rays: int = 128, row_chunk: int = 1 << 15,
                      pair_align: int = 1) -> PairTables:
    """CULL + PACK: exact per-ray candidates -> cluster-major pair table.

    The running per-cluster ray counts (the reference's lax.scan carry) give
    each pair its rank inside its cluster segment in one pass. Rows are
    culled at most `row_chunk` (and CULL_ELEMS / C) at a time; the tables
    do not depend on either. p_cap is rounded to tile_rays * pair_align."""
    from path_tracer_ai_tpu_torch.accel.worklist import _extract_k

    n = origins.shape[0]
    c = accel.num_clusters
    dev = origins.device
    t = tile_rays
    unit = t * pair_align
    p_cap = -(-(n * pair_budget) // unit) * unit
    k_eff = min(cap, c)
    step = max(1, min(row_chunk, CULL_ELEMS // c))

    counts = torch.zeros((c,), dtype=torch.int64, device=dev)
    orders, ncands, overs, ranks = [], [], [], []
    for lo in range(0, n, step):
        cand = _ray_slab_chunk(accel, origins[lo:lo + step],
                               directions[lo:lo + step], t_max[lo:lo + step],
                               t_min)
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
    order = torch.cat(orders)
    n_cand = torch.cat(ncands)
    overflow = torch.cat(overs)
    rank = torch.cat(ranks)

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
    return PairTables(pair_ray, tile_cluster, dst, n_cand, overflow, n_tiles)


def _sweep_tiles(accel, tables: PairTables, origins, directions, t_min,
                 t_max, tile_rays: int, want_tri: bool, tri_pack=None):
    """SWEEP: the pair table through ONE slot_sweep launch, per slot lane,
    over the real tiles (tables.n_tiles, read on the device; on the CPU the
    plain version sweeps them in chunks). Each slot is one lane,
    the row of its ray in a [N + 1, 8, 1] ray table; pad lanes (pair_ray
    -1) read the dead row: o 0, d 1, t_max -1. Returns per-pair (t [P],
    tri [P]) or (occluded [P],)."""
    n = origins.shape[0]
    dev = origins.device
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    rays = torch.cat([origins, directions, t_max[:, None],
                      torch.full((n, 1), t_min, dtype=torch.float32,
                                 device=dev)], dim=1)
    dead = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, -1.0, t_min]],
                        dtype=torch.float32, device=dev)
    ray_table = torch.cat([rays, dead])[:, :, None].contiguous()
    t_pair, tri_pair = cuda_ctiles.slot_sweep(
        tri_pack, ray_table, tables.pair_ray, tables.tile_cluster,
        tables.n_tiles, tile_slots=tile_rays, cap=1, out="slot")
    if want_tri:
        return t_pair, tri_pair
    return (tri_pair != I32_MAX,)


def _empty(n, want_tri, dev):
    """Fallback results of a wave where no ray overflowed: (inf t, -1 tri)
    or (False,)."""
    if want_tri:
        return (torch.full((n,), INF, dtype=torch.float32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    return (torch.zeros((n,), dtype=torch.bool, device=dev),)


def _packet_query(accel, t_min, want_tri, block, tri_pack):
    """run(o, d, t_max) through the packet cascades at `block` rays a block:
    (t, tri) or (occluded,)."""
    def run(o, d, tm):
        if want_tri:
            fb = traverse.closest_hit_packets(accel, o, d, t_min, tm,
                                              block_size=block,
                                              tri_pack=tri_pack)
            return fb.t, fb.tri
        return (traverse.any_hit_packets(accel, o, d, t_min, tm,
                                         block_size=block,
                                         tri_pack=tri_pack),)
    return run


def _whole_wave(run, origins, directions, t_max, overflow, block):
    """run over the whole wave padded to `block` rays, the rays that did
    not overflow going in dead (the cascade's dead-last sort packs them
    into inert blocks); results cut back to the wave."""
    n = origins.shape[0]
    pad = (-n) % block
    fo = torch.nn.functional.pad(origins, (0, 0, 0, pad))
    fd = torch.nn.functional.pad(directions, (0, 0, 0, pad), value=1.0)
    ftm = torch.nn.functional.pad(torch.where(overflow, t_max, -1.0),
                                  (0, pad), value=-1.0)
    return tuple(a[:n] for a in run(fo, fd, ftm))


def overflow_index(overflow, k: int) -> torch.Tensor:
    """The indices of the first k set entries of overflow [N] bool,
    ascending, then N: jnp.nonzero(overflow, size=k, fill_value=N), as a
    cumsum rank and one scatter (a static size: no host read)."""
    n = overflow.shape[0]
    rank = torch.cumsum(overflow.to(torch.int64), 0) - 1
    dest = torch.where(overflow & (rank < k), rank, k)
    idx = torch.full((k + 1,), n, dtype=torch.int64, device=overflow.device)
    idx[dest] = torch.arange(n, device=overflow.device)
    return idx[:k]


def _compacted(run, origins, directions, t_max, overflow, count, k, empty):
    """run over the `count` (<= k) overflow rays gathered into a wave of k
    (slots past the count gather ray n - 1 dead: d 1, t_max -1); results
    scattered back into copies of `empty`."""
    n = origins.shape[0]
    idx = overflow_index(overflow, k)
    live = idx < n
    gi = torch.clamp(idx, max=n - 1)
    res = run(origins[gi], torch.where(live[:, None], directions[gi], 1.0),
              torch.where(live, t_max[gi], -1.0))
    out = []
    for e, r in zip(empty, res):
        e = torch.cat([e, e[:1]])  # slot n: the sink of the fill entries
        e[idx] = r
        out.append(e[:n])
    return tuple(out)


def _overflow_fallback(accel, origins, directions, t_min, t_max, overflow,
                       want_tri: bool, compact_cap: int, fallback_block: int,
                       tri_pack=None):
    """Packet-path completion for overflow rays (pairs.py:_overflow_fallback):
    nothing when no ray overflowed, a compacted wave of k rays (compact_cap
    rounded up to fallback_block) when at most k did, else the whole wave.
    The host reads the count once. Returns wave-aligned arrays meaningful
    on overflow lanes only."""
    n = origins.shape[0]
    empty = _empty(n, want_tri, origins.device)
    count = sync.host_int(overflow.sum())
    if count == 0:
        return empty
    _add_counts(calls=1, rays=count)
    k = -(-compact_cap // fallback_block) * fallback_block
    run = _packet_query(accel, t_min, want_tri, fallback_block, tri_pack)
    if n <= k or count > k:
        _add_counts(whole_wave=1)
        return _whole_wave(run, origins, directions, t_max, overflow,
                           fallback_block)
    return _compacted(run, origins, directions, t_max, overflow, count, k,
                      empty)


def _wave_tmax(t_max, n, dev) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=dev), (n,)).contiguous()


def closest_hit_pairs(accel: ClusterAccel, origins, directions, t_min, t_max,
                      cap: int = 32, pair_budget: int = 8,
                      tile_rays: int = 128, row_chunk: int = 1 << 15,
                      tile_chunk: int = 256, fallback_block: int = 64,
                      fallback_compact: int = 4096,
                      tri_pack=None) -> PacketHit:
    """Closest hit via cluster-major pair tiles; exact for every ray (the
    fallback's rays keep the packet cascade's first-slot tie rule)."""
    t_max = _wave_tmax(t_max, origins.shape[0], origins.device)
    tables = build_pair_tables(accel, origins, directions, t_min, t_max,
                               cap=cap, pair_budget=pair_budget,
                               tile_rays=tile_rays, row_chunk=row_chunk,
                               pair_align=tile_chunk)
    t_pair, tri_pair = _sweep_tiles(accel, tables, origins, directions, t_min,
                                    t_max, tile_rays, True, tri_pack)
    p_cap = tables.pair_ray.shape[0]
    dstc = torch.clamp(tables.dst, max=p_cap - 1).long()
    valid_k = tables.dst < p_cap
    tk = torch.where(valid_k, t_pair[dstc], INF)
    best_t = tk.amin(dim=1)
    trik = torch.where(valid_k & (tk <= best_t[:, None]), tri_pair[dstc],
                       I32_MAX)
    best_tri = trik.amin(dim=1)

    fb_t, fb_tri = _overflow_fallback(
        accel, origins, directions, t_min, t_max, tables.overflow, True,
        fallback_compact, fallback_block, tri_pack)
    best_t = torch.where(tables.overflow, fb_t, best_t)
    best_tri = torch.where(tables.overflow, fb_tri, best_tri)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t,
                     tri=torch.where(hit, best_tri, -1).to(torch.int32))


def any_hit_pairs(accel: ClusterAccel, origins, directions, t_min, t_max,
                  cap: int = 32, pair_budget: int = 8, tile_rays: int = 128,
                  row_chunk: int = 1 << 15, tile_chunk: int = 256,
                  fallback_block: int = 64, fallback_compact: int = 4096,
                  tri_pack=None) -> torch.Tensor:
    """Occlusion query via cluster-major pair tiles; exact for every ray."""
    t_max = _wave_tmax(t_max, origins.shape[0], origins.device)
    tables = build_pair_tables(accel, origins, directions, t_min, t_max,
                               cap=cap, pair_budget=pair_budget,
                               tile_rays=tile_rays, row_chunk=row_chunk,
                               pair_align=tile_chunk)
    (occ_pair,) = _sweep_tiles(accel, tables, origins, directions, t_min,
                               t_max, tile_rays, False, tri_pack)
    p_cap = tables.pair_ray.shape[0]
    dstc = torch.clamp(tables.dst, max=p_cap - 1).long()
    occluded = ((tables.dst < p_cap) & occ_pair[dstc]).any(dim=1)
    (fb_occ,) = _overflow_fallback(
        accel, origins, directions, t_min, t_max, tables.overflow, False,
        fallback_compact, fallback_block, tri_pack)
    return torch.where(tables.overflow, fb_occ, occluded)
