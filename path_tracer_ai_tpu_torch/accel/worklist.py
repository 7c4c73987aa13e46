"""Block preparation, unsort and overflow completion shared by the cluster
traversals (counterpart of the parts of accel/worklist.py the main path
runs: `_prepare_blocks`, `_unsort`, `_extract_k`, `_overflow_fallback`).
"""

from __future__ import annotations

import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.traverse import _sort_rays
from path_tracer_ai_tpu_torch.utils import sync

I32_MAX = cuda_ctiles.I32_MAX
FALLBACK_TILE_LANES = 128  # rays per tile of the overflow sweep


def _extract_k(cand: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """The first k set columns of each row of [N, C] bool, ascending.

    Slots past a row's count hold `fill` (callers mask them by n_cand).
    Plays the role of the reference's descending top_k over -column ids:
    the same ascending ids, from a cumsum rank and one row scatter."""
    n, c = cand.shape
    rank = torch.cumsum(cand.to(torch.int32), dim=1)
    keep = cand & (rank <= k)
    slot = torch.where(keep, rank - 1, k).to(torch.int64)  # column k = sink
    col = torch.arange(c, dtype=torch.int32, device=cand.device).expand(n, c)
    out = torch.full((n, k + 1), fill, dtype=torch.int32, device=cand.device)
    out.scatter_(1, slot, torch.where(keep, col, fill))
    return out[:, :k]


def _prepare_blocks(accel, origins, directions, t_max, block, sort,
                    sort_mode="dir"):
    """Pad to block granularity (dead rays: o 0, d 1, t_max -1), sort for
    coherence with one packed row gather, reshape to [nb, block, ...]."""
    n = origins.shape[0]
    pad = (-n) % block
    if pad:
        origins = torch.nn.functional.pad(origins, (0, 0, 0, pad))
        directions = torch.nn.functional.pad(directions, (0, 0, 0, pad),
                                             value=1.0)
        t_max = torch.nn.functional.pad(t_max, (0, pad), value=-1.0)
    npad = n + pad
    perm = None
    if sort:
        origins, directions, t_max, perm = _sort_rays(
            accel, origins, directions, t_max, sort_mode)
    nb = npad // block
    return (
        origins.reshape(nb, block, 3),
        directions.reshape(nb, block, 3),
        t_max.reshape(nb, block),
        perm,
        npad,
    )


def _unsort(arrs, perm, npad, n):
    """Restore the original ray order: out[perm[i]] = sorted[i]."""
    if perm is None:
        return tuple(a[:n] for a in arrs)
    res = []
    for a in arrs:
        out = torch.empty_like(a)
        out[perm] = a
        res.append(out[:n])
    return tuple(res)


def _overflow_fallback(accel, origins, directions, t_min, t_max, overflow,
                       compact_cap: int, tri_pack=None):
    """Complete the closest hits of overflow rays exactly.

    The reference completes them through accel.pairs (and, beyond
    compact_cap rays, the packet cascade); neither is ported yet. Any exact
    closest-hit gives the same (t, min tri) answer, so here the overflow
    rays are compacted (as the reference does) into waves of at most
    `compact_cap` rays and swept against EVERY cluster through the
    tile-sweep kernel in 128-ray tiles; the per-cluster results
    resolve with the lexicographic (t, tri) rule.

    Returns (t [N], tri [N]), meaningful on overflow lanes only (the rest
    hold inf / -1)."""
    n = origins.shape[0]
    dev = origins.device
    t_full = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    tri_full = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx_all = torch.nonzero(overflow).squeeze(1)
    sync.note()
    count = idx_all.numel()
    if count == 0:
        return t_full, tri_full
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    c = accel.num_clusters
    tile_lanes = FALLBACK_TILE_LANES
    for lo in range(0, count, compact_cap):
        idx = idx_all[lo:lo + compact_cap]
        m = idx.numel()
        pad = (-m) % tile_lanes
        o = torch.nn.functional.pad(origins[idx], (0, 0, 0, pad))
        d = torch.nn.functional.pad(directions[idx], (0, 0, 0, pad), value=1.0)
        tm = torch.nn.functional.pad(t_max[idx], (0, pad), value=-1.0)
        rays = cuda_ctiles.pack_rays_tiles(o, d, tm, tile_lanes, t_min)
        nrt = rays.shape[0]
        rays_all = rays.repeat(c, 1, 1)                       # [c*nrt, 8, T]
        cid = torch.arange(c, dtype=torch.int32, device=dev).repeat_interleave(nrt)
        t_c, tri_c = cuda_ctiles.tile_sweep(tri_pack, rays_all, cid)
        t_c = t_c.reshape(c, nrt * tile_lanes)
        tri_c = tri_c.reshape(c, nrt * tile_lanes)
        best = t_c.amin(dim=0)
        tri = torch.where(t_c <= best, tri_c, I32_MAX).amin(dim=0)
        t_full[idx] = best[:m]
        tri_full[idx] = tri[:m].to(torch.int32)
    return t_full, tri_full
