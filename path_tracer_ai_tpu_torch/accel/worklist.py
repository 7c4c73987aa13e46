"""Block-major work-list traversal (counterpart of accel/worklist.py).

Pipeline: SORT (coherence keys, traverse._sort_keys) -> CULL (conservative
interval slab per block of `block` rays: flat against every cluster AABB,
or 2-level through the supercluster boxes past 2048 clusters; the
worklist_cull kernel, accel.cuda_cull.worklist_cull, on the card) ->
ENUMERATE (work items (block, group of `group` candidates) from cumsums, a
scatter-max and a cummax) -> SWEEP (the item-sweep kernel,
accel.cuda_items.item_sweep, which reads the item count on the device, or
with intersector="mxu" the matrix-product form of accel.mxu, over the real
items) -> RESOLVE (each block min-reduces its own item rows; the oracle's
lexicographic (t, tri) rule). In the 2-level cull the padding children of
a partly filled last super pass the slab whatever the ray (their inverted
boxes act as [-3e37, 3e37]), as in the reference: repeats of cluster C - 1
that change no result but count against `cap` (cuda_cull._cull_2level).

Blocks whose candidates exceed `cap`, or whose items spill past the static
item budget, complete through `_overflow_fallback`: per-ray pair tiles
(accel.pairs) on a compacted wave, or the packet cascades on the whole
wave. The module also holds the block preparation, unsort and extraction
helpers that accel.ctiles shares. The static sizes (i_cap rounded to
item_chunk, the fallback's compact_cap) are the reference's, so the
overflow sets are too.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple

import torch
from torch.profiler import record_function

from path_tracer_ai_tpu_torch.accel import (
    cuda_ctiles,
    cuda_cull,
    cuda_items,
    mxu,
    pairs,
)
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.traverse import (
    PacketHit,
    _sort_rays,
    pack_block_rays,
)
from path_tracer_ai_tpu_torch.utils import sync

I32_MAX = cuda_ctiles.I32_MAX
INF = float("inf")

# Overflow completions of this module since the last reset: calls with
# overflow rays, the blocks and rays sent, the rays that went through
# accel.pairs and the calls that took the whole wave.
fallback_counts = {"calls": 0, "blocks": 0, "rays": 0, "pairs_rays": 0,
                   "whole_wave": 0}
# When a caller sets this to a dict, each stage of a worklist query records
# CUDA events under (wave, stage): wave "closest" or "shadow", stage "build"
# (sort, cull and item table; each also on its own as "sort", "cull" and
# "table"), "sweep" (the item sweep and resolve) or "fallback";
# stage_seconds() sums them. None: nothing is recorded.
stage_events = None


def reset_fallback_counts() -> None:
    with sync.lock:
        for k in fallback_counts:
            fallback_counts[k] = 0


def _add_counts(**add) -> None:
    with sync.lock:  # the mesh's workers query from several threads
        for k, v in add.items():
            fallback_counts[k] += v


def stage_seconds() -> dict:
    """Device seconds of each recorded (wave, stage), after a synchronize."""
    return event_seconds(stage_events)


def event_seconds(events) -> dict:
    """{"<wave>_<stage>": device seconds} of a dict of recorded CUDA event
    pairs (StageTimer's), after a synchronize."""
    torch.cuda.synchronize()
    return {f"{wave}_{stage}": sum(a.elapsed_time(b) for a, b in ev) / 1e3
            for (wave, stage), ev in (events or {}).items()}


class StageTimer:
    """A stage of a query: a torch.profiler label and, when `events` is a
    dict and the wave is on the card, a pair of CUDA events appended to
    events[key]."""

    def __init__(self, events, key, label: str, device):
        self.events, self.key = events, key
        self.timed = events is not None and device.type == "cuda"
        self.label = record_function(label)

    def __enter__(self):
        self.label.__enter__()
        if self.timed:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def __exit__(self, *exc):
        if self.timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.setdefault(self.key, []).append((self.start, end))
        self.label.__exit__(*exc)


def _stage(wave: str, stage: str, device) -> StageTimer:
    return StageTimer(stage_events, (wave, stage), f"worklist_{wave}_{stage}",
                      device)


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
                       want_tri: bool, compact_cap: int, fallback_block: int,
                       tri_pack=None, over_blocks=None):
    """Complete overflow rays exactly (worklist.py:48-144): nothing when no
    ray overflowed; per-ray pair tiles (accel.pairs, cap 64, pair budget 12)
    on the wave itself when it holds at most compact_cap rays, or on the
    overflow rays compacted into a wave of compact_cap when at most that
    many overflowed; the packet cascades on the whole wave otherwise. The
    host reads the count once (and the overflow blocks `over_blocks` with
    it). Returns wave-aligned arrays meaningful on overflow lanes only."""
    n = origins.shape[0]
    empty = pairs._empty(n, want_tri, origins.device)
    counts = [overflow.sum()] + ([over_blocks] if over_blocks is not None
                                 else [])
    counts = torch.stack(counts).tolist()
    sync.note()
    count = counts[0]
    if count == 0:
        return empty
    _add_counts(calls=1, rays=count,
                blocks=counts[1] if len(counts) > 1 else 0)

    def pair_query(o, d, tm):
        _add_counts(pairs_rays=count)
        kw = dict(cap=64, pair_budget=12, fallback_block=fallback_block,
                  tri_pack=tri_pack)
        if want_tri:
            fb = pairs.closest_hit_pairs(accel, o, d, t_min, tm, **kw)
            return fb.t, fb.tri
        return (pairs.any_hit_pairs(accel, o, d, t_min, tm, **kw),)

    k = min(compact_cap, n)
    if n <= k:
        return pair_query(origins, directions,
                          torch.where(overflow, t_max, -1.0))
    if count > k:
        _add_counts(whole_wave=1)
        return pairs._whole_wave(
            pairs._packet_query(accel, t_min, want_tri, fallback_block,
                                tri_pack),
            origins, directions, t_max, overflow, fallback_block)
    return pairs._compacted(pair_query, origins, directions, t_max, overflow,
                            count, k, empty)


class WorkList(NamedTuple):
    item_block: torch.Tensor  # [I] i32 block id per work item
    ibase: torch.Tensor       # [nb] i32 first item of each block
    order_g: torch.Tensor     # [nb, n_groups, g] i32 candidate cluster ids
    n_cand: torch.Tensor      # [nb] i32 candidates per block (0 if overflow)
    overflow: torch.Tensor    # [nb] bool block completes via fallback
    n_items: torch.Tensor     # [] i32 real item count


def _build_worklist(accel: ClusterAccel, o_blk, d_blk, tm_blk, t_min,
                    cap: int, group: int, item_budget: int, row_chunk: int,
                    item_align: int, levels: int = 0,
                    super_cap: int = 32, wave=None) -> WorkList:
    """CULL + ENUMERATE (worklist.py:169-281). levels 0 picks the 2-level
    cull past 2048 clusters, else the flat one. The cull is one launch of
    the worklist_cull kernel on the card (accel.cuda_cull.worklist_cull,
    which raises if it cannot run), its plain version on the CPU (blocks
    culled at most `row_chunk` at a time; the tables do not depend on
    it). `wave` ("closest" or "shadow"; None: untimed) names the stage
    timers of the cull and the table (see stage_events)."""
    nb = o_blk.shape[0]
    c = accel.num_clusters
    dev = o_blk.device
    if levels == 0:
        levels = 2 if c > 2048 else 1
    g = group
    i_cap = -(-(nb * item_budget) // item_align) * item_align
    k_eff = min(cap, c)
    if levels == 2:
        # The 2-level cull sees at most super_cap * super_size children.
        k_eff = min(k_eff, min(super_cap, accel.num_supers)
                    * accel.super_size)
    n_groups = -(-k_eff // g)

    with _stage(wave, "cull", dev) if wave else nullcontext():
        if dev.type == "cpu":
            order, n_cand, overflow = cuda_cull.worklist_cull_plain(
                accel, o_blk, d_blk, tm_blk, cap, k_eff, n_groups * g,
                levels, super_cap, row_chunk)
        else:
            order, n_cand, overflow = cuda_cull.worklist_cull(
                accel, o_blk.contiguous(), d_blk.contiguous(),
                tm_blk.contiguous(), cap, k_eff, n_groups * g, levels,
                super_cap)

    with _stage(wave, "table", dev) if wave else nullcontext():
        m = torch.div(n_cand + (g - 1), g, rounding_mode="floor")  # items
        ibase = torch.cumsum(m, 0) - m
        # Blocks whose items spill past the static budget -> fallback.
        over_budget = ibase + m > i_cap
        overflow = overflow | over_budget
        m = torch.where(over_budget, 0, m)
        n_cand = torch.where(over_budget, 0, n_cand).to(torch.int32)
        ibase = torch.cumsum(m, 0) - m
        n_items = m.sum().to(torch.int32)

        # item -> owning block: mark each non-empty block's first item with
        # its id (scatter-max; empty blocks go to the sink slot i_cap),
        # forward-fill.
        mark_pos = torch.where(m > 0, ibase, i_cap).long()
        item_block = torch.zeros((i_cap + 1,), dtype=torch.int64, device=dev)
        item_block.scatter_reduce_(0, mark_pos, torch.arange(nb, device=dev),
                                   "amax")
        item_block = torch.cummax(item_block[:i_cap],
                                  0).values.to(torch.int32)
    return WorkList(item_block, ibase.to(torch.int32),
                    order.reshape(nb, n_groups, g), n_cand, overflow,
                    n_items)


INTERSECTORS = ("exact", "mxu", "mxu:highest", "mxu:high", "mxu:default")
# [items, B, g * S] elements per step of the mxu item sweep.
MXU_ELEMS = 1 << 23


def _sweep_items(accel, wl: WorkList, rays, want_tri: bool,
                 intersector: str = "exact", tri_pack=None):
    """The item sweep (worklist.py:325-422) over the real items: per item
    row (t [i_cap, B], tri [i_cap, B]) or (occluded [i_cap, B],); rows past
    n_items hold (inf, INT32_MAX) or False. rays: [nb, 8, B] block pack.

    intersector "exact": Möller–Trumbore, bitwise the brute-force oracle's
    (the item-sweep kernel, accel.cuda_items, B = 8, g = 4). "mxu": the
    matrix-product decomposition (accel.mxu) in eager torch, same math with
    other rounding, at any B (use blocks of 64 or more, so the product has
    rows to fill); "mxu:<precision>" picks mxu.PRECISIONS ("mxu" is
    "mxu:highest"). The reference treats any name that does not start with
    "mxu" as exact; the port raises ValueError for a name outside
    INTERSECTORS."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"intersector {intersector!r} is not one of "
                         f"{INTERSECTORS}")
    if intersector != "exact":
        precision = intersector.partition(":")[2] or "highest"
        return _sweep_items_mxu(accel, wl, rays, sync.host_int(wl.n_items),
                                want_tri, precision)
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    # the kernel reads the item count on the device (the reference's
    # fori_loop to the traced count): no host read
    return cuda_items.item_sweep(tri_pack, rays, wl.item_block, wl.ibase,
                                 wl.order_g, wl.n_cand, wl.n_items, want_tri)


def _sweep_items_mxu(accel, wl: WorkList, rays, n_items: int, want_tri: bool,
                     precision: str):
    """The "mxu" item sweep: items [0, n_items) in steps of MXU_ELEMS
    [items, B, g * S] elements; returns what cuda_items.item_sweep
    returns."""
    b = rays.shape[2]
    n_groups, g = wl.order_g.shape[1:]
    s = accel.cluster_size
    dev = rays.device
    i_cap = wl.item_block.shape[0]
    w_table = mxu.build_linear_table(accel)                   # [C, 10, S, 4]
    rt = rays.transpose(1, 2)                                 # [nb, B, 8]
    g_blocks = mxu.ray_features(rt[..., 0:3], rt[..., 3:6])   # [nb, B, 10]
    out = cuda_items._outputs(i_cap, b, want_tri, dev)
    step = max(1, MXU_ELEMS // (b * g * s))
    for a in range(0, n_items, step):
        j = torch.arange(a, min(a + step, n_items), device=dev)
        blk = wl.item_block[j].long()
        k = torch.clamp(j - wl.ibase[blk].long(), 0, n_groups - 1)
        cid = wl.order_g[blk, k].long()                       # [ic, g]
        wg = w_table[cid].transpose(1, 2).reshape(j.shape[0], 10, g * s, 4)
        tt, ok = mxu.mxu_sweep(g_blocks[blk], wg, rt[blk, :, 7, None],
                               rt[blk, :, 6], precision)      # [ic, B, g*S]
        slot_live = (k[:, None] * g + torch.arange(g, device=dev)[None, :]
                     < wl.n_cand[blk][:, None])               # [ic, g]
        ok = ok & slot_live.repeat_interleave(s, dim=1)[:, None, :]
        rows = slice(a, a + j.shape[0])
        if not want_tri:
            out[0][rows] = ok.any(dim=-1)
            continue
        tt = torch.where(ok, tt, INF)
        ct = tt.amin(dim=-1)                                  # [ic, B]
        tid = accel.tri_id[cid].reshape(j.shape[0], 1, -1)
        out[0][rows] = ct
        out[1][rows] = torch.where(ok & (tt <= ct[..., None]), tid,
                                   I32_MAX).amin(dim=-1)
    return out


def _item_rows(wl: WorkList, group: int):
    """Each block's item rows [nb, n_groups] (clamped) and which are live."""
    n_groups = wl.order_g.shape[1]
    i_cap = wl.item_block.shape[0]
    dev = wl.ibase.device
    ar = torch.arange(n_groups, device=dev)[None, :]
    rows = wl.ibase.long()[:, None] + ar
    m = torch.div(wl.n_cand + (group - 1), group, rounding_mode="floor")
    return torch.clamp(rows, max=i_cap - 1), ar < m[:, None]


def _query(accel, origins, directions, t_min, t_max, want_tri, block, group,
           cap, item_budget, row_chunk, item_chunk, sort, sort_mode,
           intersector, levels, super_cap, fallback_block, fallback_compact,
           tri_pack):
    n = origins.shape[0]
    dev = origins.device
    wave = "closest" if want_tri else "shadow"
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    with _stage(wave, "build", dev):
        with _stage(wave, "sort", dev):
            o_blk, d_blk, tm_blk, perm, npad = _prepare_blocks(
                accel, origins, directions, t_max, block, sort, sort_mode)
        wl = _build_worklist(accel, o_blk, d_blk, tm_blk, t_min, cap, group,
                             item_budget, row_chunk, item_align=item_chunk,
                             levels=levels, super_cap=super_cap, wave=wave)
    nb = o_blk.shape[0]
    with _stage(wave, "sweep", dev):
        res = _sweep_items(accel, wl, pack_block_rays(o_blk, d_blk, tm_blk,
                                                      t_min),
                           want_tri, intersector, tri_pack)
        rowsc, row_live = _item_rows(wl, group)
        if want_tri:
            t_items, tri_items = res
            tk = torch.where(row_live[..., None], t_items[rowsc], INF)
            best_t = tk.amin(dim=1)                            # [nb, B]
            trik = torch.where(row_live[..., None]
                               & (tk <= best_t[:, None, :]),
                               tri_items[rowsc], I32_MAX)
            out = (best_t.reshape(-1), trik.amin(dim=1).reshape(-1))
        else:
            (occ_items,) = res
            out = ((row_live[..., None] & occ_items[rowsc]).any(dim=1)
                   .reshape(-1),)
        over_blk = wl.overflow[:, None].expand(nb, block).reshape(-1)
        *out, overflow_ray = _unsort(out + (over_blk,), perm, npad, n)
    with _stage(wave, "fallback", dev):
        fb = _overflow_fallback(accel, origins, directions, t_min, t_max,
                                overflow_ray, want_tri, fallback_compact,
                                fallback_block, tri_pack,
                                over_blocks=wl.overflow.sum())
    return [torch.where(overflow_ray, f, r) for f, r in zip(fb, out)]


def closest_hit_worklist(accel: ClusterAccel, origins, directions, t_min,
                         t_max, block: int = 8, group: int = 4, cap: int = 64,
                         item_budget: int = 6, row_chunk: int = 1 << 13,
                         item_chunk: int = 1024, sort: bool = True,
                         sort_mode: str = "dir", intersector: str = "exact",
                         levels: int = 0, super_cap: int = 32,
                         fallback_block: int = 64,
                         fallback_compact: int = 32768,
                         tri_pack=None) -> PacketHit:
    """Closest hit via the block-major work list; exact for every ray (the
    fallback's packet-cascade rays keep its first-slot tie rule)."""
    best_t, best_tri = _query(
        accel, origins, directions, t_min, t_max, True, block, group, cap,
        item_budget, row_chunk, item_chunk, sort, sort_mode, intersector,
        levels, super_cap, fallback_block, fallback_compact, tri_pack)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t,
                     tri=torch.where(hit, best_tri, -1).to(torch.int32))


def any_hit_worklist(accel: ClusterAccel, origins, directions, t_min, t_max,
                     block: int = 8, group: int = 4, cap: int = 64,
                     item_budget: int = 6, row_chunk: int = 1 << 13,
                     item_chunk: int = 1024, sort: bool = True,
                     sort_mode: str = "dir", intersector: str = "exact",
                     levels: int = 0, super_cap: int = 32,
                     fallback_block: int = 64, fallback_compact: int = 32768,
                     tri_pack=None) -> torch.Tensor:
    """Occlusion query via the block-major work list; exact for every ray."""
    (occ,) = _query(
        accel, origins, directions, t_min, t_max, False, block, group, cap,
        item_budget, row_chunk, item_chunk, sort, sort_mode, intersector,
        levels, super_cap, fallback_block, fallback_compact, tri_pack)
    return occ
