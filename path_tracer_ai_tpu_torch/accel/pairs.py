"""Cluster-major pair-tile traversal: exact per-ray work, dense tiles.

Counterpart of accel/pairs.py (the whole module):

1. CULL    — every ray gets its own exact inclusive slab test against all
             cluster AABBs (the reference's comparison-select form).
2. PACK    — the surviving (ray, cluster) pairs are packed cluster-major:
             each cluster owns a contiguous segment of pair slots padded to
             `tile_rays`; one permutation scatter builds the table.
             CULL + PACK are `build_pair_tables`: on the card three
             launches of accel.cuda_cull.pair_tables (csrc/ray_cull.cu),
             which read nothing on the host; on the CPU its plain version,
             cuda_cull.pair_tables_plain, eager in row steps.
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

from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_cull, traverse
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

I32_MAX = cuda_ctiles.I32_MAX
INF = float("inf")

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


def build_pair_tables(accel: ClusterAccel, origins, directions, t_min, t_max,
                      cap: int = 32, pair_budget: int = 8,
                      tile_rays: int = 128, row_chunk: int = 1 << 15,
                      pair_align: int = 1) -> PairTables:
    """CULL + PACK: exact per-ray candidates -> cluster-major pair table.

    Each pair's rank inside its cluster segment counts the rays before its
    ray that hold the cluster (the reference's lax.scan carry). CPU tensors
    take cuda_cull.pair_tables_plain, in steps of at most `row_chunk` rows
    (and PAIR_CULL_ELEMS / C); anything else the kernels
    (cuda_cull.pair_tables, which raises where it cannot launch); the
    tables depend on neither step. p_cap is rounded to tile_rays *
    pair_align; n_tiles stays on the device."""
    if origins.device.type == "cpu":
        out = cuda_cull.pair_tables_plain(
            accel, origins, directions, t_min, t_max, cap, pair_budget,
            tile_rays, pair_align, row_chunk=row_chunk)
    else:
        out = cuda_cull.pair_tables(
            accel, origins.contiguous(), directions.contiguous(), t_min,
            t_max.contiguous(), cap, pair_budget, tile_rays, pair_align)
    return PairTables(*out)


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
