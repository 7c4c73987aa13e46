"""Per-ray K-slot traversal (counterpart of accel/kslots.py): exact per-ray
candidates, one dense sweep.

Every ray gets its own K candidate slots; no blocks, no sort, no scatter,
no cascade:

1. CULL    — per-ray inclusive slab, two fixed levels past 64 clusters:
             the supercluster AABBs first, then the gathered children of
             the first `k_supers` surviving supers (`levels=1`: every
             cluster AABB).
2. EXTRACT — the k lowest candidate columns of each row, ascending
             (worklist._extract_k, straight from the bool matrix). The
             reference packs the set into 32-bit words and peels them;
             `_pack_bits` and `_peel_k` keep that contract, bitwise, and
             give the same ids. On the card CULL + EXTRACT are one launch
             of the kslots_cull kernel (csrc/ray_cull.cu via
             accel.cuda_cull); the CPU runs its plain version, the eager
             body in row chunks of `row_chunk` rays.
3. SWEEP   — csrc/kslot_sweep.cu (accel.cuda_kslots): each ray tests the S
             triangles of its n_slots clusters, and
4. RESOLVE — in the same kernel, with the brute-force oracle's
             lexicographic (t, triangle id) rule.

Rays with more than `k_supers` supers or more than `k_clusters` clusters
overflow and complete exactly through worklist._overflow_fallback (pair
tiles on a compacted wave), which reads the overflow count on the host
once a query. On the CPU the cull runs in row chunks of `row_chunk` rays,
so its memory is O(row_chunk * K * S); the last chunk is ragged where the
reference pads it with dead rows (d 1, t_max -1), which changes nothing,
rows being independent. The sweep is one launch over the query's rays.

Phantom children. The padding children of a partly filled last super hold
inverted boxes (lo = +3e37, hi = -3e37), but the slab takes the min and
max of t0 and t1 per axis, so an inverted box acts as [-3e37, 3e37] and
passes for every ray (the reference's comment, kslots.py:134-135, says
they fail). They get cid = min(sup * super_size + j, C - 1), repeats of
cluster C - 1 that change no result but use up `k_clusters`: a ray whose
supers include such a last super can overflow for that alone. The port
keeps this bit for bit and counts those rays (`read_overflow_counts`).
"""

from __future__ import annotations

import torch

from path_tracer_ai_tpu_torch.accel import (
    cuda_ctiles,
    cuda_cull,
    cuda_kslots,
    worklist,
)
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.accel.traverse import PacketHit
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
I32_MAX = cuda_ctiles.I32_MAX

# Rays of the queries since the last reset (device sums, one a device,
# read by read_overflow_counts): live rays queried, those over k_supers,
# those over k_clusters (and not k_supers), those over k_clusters only
# because of phantom children, and the live slots swept. Updated under
# sync.lock (the mesh's workers query from several threads).
COUNT_KEYS = ("rays", "over_supers", "over_clusters", "phantom_only",
              "slots")
_counts: dict = {}
queries = 0
# When a caller sets this to a dict, each stage of a kslots query records
# CUDA events under (wave, stage): wave "closest" or "shadow", stage "cull"
# (slab descent and extraction), "sweep" (kslot_sweep) or "fallback";
# stage_seconds() sums them. None: nothing is recorded.
stage_events = None


def reset_overflow_counts() -> None:
    global queries
    with sync.lock:
        _counts.clear()
        queries = 0


def read_overflow_counts() -> dict:
    """{"queries": n, key: count for COUNT_KEYS} since the last reset (one
    host read a device)."""
    vals = [0] * len(COUNT_KEYS)
    for sums in list(_counts.values()):
        vals = [a + b for a, b in zip(vals, sums.tolist())]
    return {"queries": queries, **dict(zip(COUNT_KEYS, vals))}


def stage_seconds() -> dict:
    """Device seconds of each recorded (wave, stage), after a synchronize."""
    return worklist.event_seconds(stage_events)


def _stage(wave: str, stage: str, device) -> worklist.StageTimer:
    return worklist.StageTimer(stage_events, (wave, stage),
                               f"kslots_{wave}_{stage}", device)


def _pack_bits(cand: torch.Tensor) -> torch.Tensor:
    """[N, C] bool -> [N, W] candidate bitmask words (W = ceil(C / 32)),
    int64 holding the reference's uint32 values."""
    n, c = cand.shape
    w = -(-c // 32)
    bits = torch.nn.functional.pad(cand.to(torch.int64), (0, w * 32 - c))
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=cand.device),
        torch.arange(32, device=cand.device))
    return (bits.reshape(n, w, 32) * weights).sum(dim=-1)


def _peel_k(words: torch.Tensor, k: int, sentinel: int) -> torch.Tensor:
    """The k lowest set bit positions of [N, W] words -> [N, k] i32,
    ascending; rows with fewer than k set bits get `sentinel` in the rest.
    Torch has no popcount: the words are unpacked and the ascending ids
    taken by worklist._extract_k (a cumsum rank and one row scatter), the
    same ids the reference peels bit by bit."""
    n, w = words.shape
    shifts = torch.arange(32, device=words.device)
    cand = ((words[:, :, None] >> shifts) & 1).bool().reshape(n, w * 32)
    return worklist._extract_k(cand, k, sentinel)


def _ray_slab(bmin, bmax, o, d, lo0, hi0):
    """Per-ray inclusive slab test: [N, 3] rays vs [K, 3] or [N, K, 3]
    boxes -> [N, K] bool.

    lo0/hi0: [N] initial interval (t_min, per-ray t_max). Inclusive bounds
    (hi >= lo) keep flat AABBs in. A 0*inf NaN (origin exactly on a slab
    plane of an axis-parallel ray) must not exclude: torch.minimum/maximum
    propagate it, so it is replaced by the identity bound of that axis."""
    inv = 1.0 / d
    if bmin.dim() == 2:
        bmin = bmin[None]
        bmax = bmax[None]
    o_ = o[:, None, :]
    inv_ = inv[:, None, :]
    t0 = (bmin - o_) * inv_
    t1 = (bmax - o_) * inv_
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    near = torch.where(torch.isnan(near), -INF, near)
    far = torch.where(torch.isnan(far), INF, far)
    lo = torch.maximum(near.amax(dim=-1), lo0[:, None])
    hi = torch.minimum(far.amin(dim=-1), hi0[:, None])
    return hi >= lo


def resolve_levels(accel: ClusterAccel, levels: int) -> int:
    """levels 0: the flat slab only while C <= 64 (it pays only there), the
    2-level descent past that."""
    if levels == 0:
        return 1 if accel.num_clusters <= 64 else 2
    return levels


def _tables(accel, origins, directions, t_max, t_min, k_supers: int,
            k_clusters: int, levels: int, row_chunk: int) -> dict:
    """CULL + EXTRACT of the query's rays (kslots.py:106-163): the [N, K]
    cid table (clamped to C - 1, phantom children included), n_slots (0 on
    overflow), over, n_cand, the overflow split (over_supers,
    over_clusters, phantom_only) and live. On the card one launch of the
    kslots_cull kernel (accel.cuda_cull), which raises if it cannot run;
    on the CPU its plain version, eager torch in row chunks of
    `row_chunk`."""
    levels = resolve_levels(accel, levels)
    if origins.device.type == "cpu":
        return cuda_cull.kslots_cull_plain(accel, origins, directions, t_max,
                                           t_min, k_supers, k_clusters,
                                           levels, row_chunk)
    return cuda_cull.kslots_cull(accel, origins.contiguous(),
                                 directions.contiguous(), t_max.contiguous(),
                                 t_min, k_supers, k_clusters, levels)


def _run(accel, origins, directions, t_min, t_max, k_supers, k_clusters,
         levels, row_chunk, want_tri, tri_pack):
    """The cull (one kslots_cull launch on the card), then one kslot_sweep
    over the query's rays.
    Returns ((t, tri) or (occluded,), over)."""
    global queries
    dev = origins.device
    wave = "closest" if want_tri else "shadow"
    with _stage(wave, "cull", dev):
        tab = _tables(accel, origins, directions, t_max, t_min, k_supers,
                      k_clusters, levels, row_chunk)
        over = tab["over"]
        tb = torch.where(tab["live"] & ~over, t_max, -1.0)
        sums = torch.stack([tab["live"].sum(), tab["over_supers"].sum(),
                            tab["over_clusters"].sum(),
                            tab["phantom_only"].sum(),
                            tab["n_slots"].sum()])
        with sync.lock:
            _counts[dev] = sums + _counts[dev] if dev in _counts else sums
            queries += 1
    with _stage(wave, "sweep", dev):
        res = cuda_kslots.kslot_sweep(
            tri_pack, cuda_kslots.pack_rays(origins, directions, tb, t_min),
            tab["cid"], tab["n_slots"], want_tri)
    return res, over


def _query(accel, origins, directions, t_min, t_max, want_tri, k_supers,
           k_clusters, levels, row_chunk, fallback_block, fallback_compact,
           tri_pack):
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    res, over = _run(accel, origins, directions, t_min, t_max, k_supers,
                     k_clusters, levels, row_chunk, want_tri, tri_pack)
    with _stage("closest" if want_tri else "shadow", "fallback", dev):
        fb = worklist._overflow_fallback(
            accel, origins, directions, t_min, t_max, over, want_tri,
            fallback_compact, fallback_block, tri_pack)
    return [torch.where(over, f, r) for f, r in zip(fb, res)]


def closest_hit_kslots(accel: ClusterAccel, origins, directions, t_min,
                       t_max, k_supers: int = 6, k_clusters: int = 12,
                       levels: int = 0, row_chunk: int = 1 << 15,
                       fallback_block: int = 64,
                       fallback_compact: int = 1 << 17,
                       tri_pack=None) -> PacketHit:
    """Closest hit via per-ray K slots; exact for every ray, with the
    oracle's (t, min triangle id) rule (the fallback's packet-cascade rays,
    past fallback_compact overflow rays, keep its first-slot rule)."""
    best_t, best_tri = _query(
        accel, origins, directions, t_min, t_max, True, k_supers,
        k_clusters, levels, row_chunk, fallback_block, fallback_compact,
        tri_pack)
    hit = torch.isfinite(best_t)
    return PacketHit(hit=hit, t=best_t,
                     tri=torch.where(hit, best_tri, -1).to(torch.int32))


def any_hit_kslots(accel: ClusterAccel, origins, directions, t_min, t_max,
                   k_supers: int = 6, k_clusters: int = 12, levels: int = 0,
                   row_chunk: int = 1 << 15, fallback_block: int = 64,
                   fallback_compact: int = 1 << 17,
                   tri_pack=None) -> torch.Tensor:
    """Occlusion query via per-ray K slots; exact for every ray."""
    (occ,) = _query(
        accel, origins, directions, t_min, t_max, False, k_supers,
        k_clusters, levels, row_chunk, fallback_block, fallback_compact,
        tri_pack)
    return occ
