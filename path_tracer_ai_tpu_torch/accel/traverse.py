"""Packet traversal of the cluster structure: the shadow cascade.

Counterpart of accel/traverse.py, the parts the main path runs:
`any_hit_packets` (traverse.py:877-970) and its helpers.

1. SORT  — coherence keys (octant | direction Morton | origin Morton, dead
           rays last) and one stable argsort.
2. CULL  — per block of rays, a conservative interval slab test against
           every cluster AABB; candidates ordered by conservative entry
           (on the card one launch of the packet_cull kernel,
           accel.cuda_cull; on the CPU its plain version).
3. SWEEP — the cascade: each iteration sweeps the next `group_size`
           candidates of every active block; a stage runs until at most half
           its blocks are active, then compacts them to the front (one
           whole-array gather) and continues on half the slice.

`any_hit_packets` and `closest_hit_packets` run the cascade as the
reference does (`_cascade_stages`): static stages, each ONE launch of the
cascade stage kernel (accel.cuda_cascade.cascade_stage), which keeps the
stage's loop, its active count and k on the card, as the reference's
while_loop does; between stages the compaction is a stable argsort and a
whole-array gather, on the device. Neither reads the host. At
exact_cull=K the cull is the per-ray-exact one, `_exact_block_candidates`
(on the card a packet_cull launch and an exact_cull launch; on the CPU its
plain version, which reads the live block count, `live_block_count`). On
the CPU the stage runs its plain version, a host loop over tile_sweep's
plain version.

The fused cascades of accel.cuda_anyhit and accel.cuda_closest run the
same static stages, each ONE call of accel.cuda_cascade.fused_stage
(on the card one launch of the stage kernel with the fused folds, whose
sweeps are block_anyhit's and block_closest's bodies); they read the host
once a cascade, the candidate ids' range check. On the CPU their stage
runs its plain version, `_stepped_stage` with the kernels' plain versions.

The perray queries (`closest_hit_perray`, `any_hit_perray`: blocks of one
ray) run the same static stages, each ONE call of
accel.cuda_cascade.perray_stage (on the card one launch of the stage
kernel with the perray folds, whose sweeps are the per-ray K-slot sweep's
walk of one ray, csrc/kslot_sweep.cu); they read the host once a call, the
overflow count. Their candidate lists are one launch of the perray_cull
kernel on the card (accel.cuda_cull, csrc/ray_cull.cu; order_mode "entry"
one launch of perray_entry). In the reference
these sweeps and lists are XLA-fused bodies, not Pallas kernels. On the
CPU their stage runs its plain version over the plain eager sweeps
`_packet_sweep_closest` / `_packet_sweep_any`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.accel import (
    cuda_cascade,
    cuda_ctiles,
    cuda_cull,
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


def _block_candidates(accel, o_blk, d_blk, t_max_blk,
                      with_entry: bool = True):
    """Conservative candidate clusters per ray block, front to back.

    Returns (order [B, C] i32 cluster ids by ascending conservative entry,
    candidates first; n_cand [B] i32; entry_sorted [B, C], or None where
    with_entry is False). On the card one launch of the packet_cull kernel
    (accel.cuda_cull.block_candidates), which raises if it cannot run; on
    the CPU its plain version, eager torch in row chunks."""
    if o_blk.device.type == "cpu":
        return cuda_cull.block_candidates_plain(accel, o_blk, d_blk,
                                                t_max_blk, with_entry)
    return cuda_cull.block_candidates(accel, o_blk.contiguous(),
                                      d_blk.contiguous(),
                                      t_max_blk.contiguous(), with_entry)


def _exact_block_candidates(accel, o_blk, d_blk, tm_blk, t_min,
                            ksup: int = 16, live_blocks=None):
    """Per-ray-exact OR-union candidate clusters per block
    (traverse.py:205-398): the union over a block's live lanes of the
    clusters each lane's own slab test passes, through the 2-level
    hierarchy (each lane against the supers, the block's first `ksup`
    supers in ascending id, each lane against their children). A block
    whose super union exceeds ksup takes the conservative list. Returns
    _block_candidates' tables (order [nb, C] i32, n_cand [nb] i32,
    entry_sorted [nb, C]), the exact ids ordered by conservative entry.

    On the card one packet_cull launch and one exact_cull launch
    (accel.cuda_cull.exact_cull), which raises if it cannot run and needs
    no live-block count (live_blocks is not read); on the CPU its plain
    version, eager torch, whose stages skip the blocks from live_blocks on
    (an int, valid only when those blocks are all dead, as on a wave
    sorted dead-last)."""
    if o_blk.device.type == "cpu":
        return cuda_cull.exact_cull_plain(accel, o_blk, d_blk, tm_blk, t_min,
                                          ksup, live_blocks)
    return cuda_cull.exact_cull(accel, o_blk.contiguous(),
                                d_blk.contiguous(), tm_blk.contiguous(),
                                t_min, ksup)


def live_block_count(t_max_blk) -> int:
    """Blocks with a live lane (t_max >= 0), read once by the host; on a
    wave sorted dead-last they are a prefix. Only the CPU's exact cull
    reads it (the card's kernel needs no count)."""
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
    (_stepped_stage): the loop the perray queries ran before their stage
    kernel, kept for comparison.

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
        # a sorted wave is dead-last: its live blocks are a prefix (read on
        # the CPU only)
        live = sort and dev.type == "cpu"
        order, n_cand, _entry = _exact_block_candidates(
            accel, o_blk, d_blk, tmax_blk, t_min, ksup=exact_cull,
            live_blocks=live_block_count(tmax_blk) if live else None)
    else:
        order, n_cand, _entry = _block_candidates(accel, o_blk, d_blk,
                                                  tmax_blk, with_entry=False)
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
# swept this many at a time. On the card a stage is one kernel launch. The
# results do not depend on the step.
PACKET_SWEEP_ELEMS = 1 << 26


def _kernel_sweeps(dev) -> bool:
    """Whether the perray queries' stages on `dev` go through
    cuda_cascade.perray_stage (a CUDA device: the stage kernel) or run its
    plain version over the plain eager sweeps below (the CPU)."""
    return dev.type == "cuda"


def _packet_sweep_closest(accel, ob, db, t_cap, cid, t_min):
    """Blocks of rays ob/db [n, R, 3] (window [t_min, t_cap [n, R]]) against
    the g * S triangles of their clusters cid [n, g], in eager torch
    (traverse._mt_sweep's arithmetic): returns (ct [n, R] min t, gid [n, R]
    the triangle id of the FIRST slot achieving it; on a miss, inf and the
    id of slot 0). The perray query's plain closest sweep, run on the
    CPU."""
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
    comparison-select form: a 0 * inf NaN keeps the running bound).

    order_mode "id": ascending cluster ids (slots past the count hold
    C - 1), entry 0; on the card one launch of the perray_cull kernel
    (accel.cuda_cull), which raises if it cannot run; on the CPU its plain
    version (cumsum + searchsorted, rows `row_chunk` at a time). "entry"
    (no query takes it): front to back by slab entry (a stable argsort;
    past the count, the non-candidates in id order), entry the entry t
    (inf past the count); on the card one launch of the perray_entry
    kernel, on the CPU its plain version (rows `row_chunk` at a time).
    Columns past C, where cap > C, hold 0 and entry inf.
    Returns (order [N, cap] i32, n_cand [N] i32 clipped to cap, entry
    [N, cap] f32, overflow [N] bool: more than cap candidates)."""
    n = origins.shape[0]
    dev = origins.device
    if order_mode == "entry":
        if dev.type == "cpu":
            return cuda_cull.perray_entry_plain(accel, origins, directions,
                                                t_min, t_max, cap, row_chunk)
        return cuda_cull.perray_entry(accel, origins.contiguous(),
                                      directions.contiguous(), t_min,
                                      t_max.contiguous(), cap)
    if dev.type == "cpu":
        order, n_cand, overflow = cuda_cull.perray_cull_plain(
            accel, origins, directions, t_min, t_max, cap, row_chunk)
    else:
        order, n_cand, overflow = cuda_cull.perray_cull(
            accel, origins.contiguous(), directions.contiguous(), t_min,
            t_max.contiguous(), cap)
    entry = torch.full((n, cap), INF, dtype=torch.float32, device=dev)
    entry[:, :min(cap, accel.num_clusters)] = 0.0
    return order, n_cand, entry, overflow


def _perray_setup(accel, origins, directions, t_min, t_max, cap, group_size):
    """The perray queries' common part: per-ray candidates (overflow rays
    get none), grouped [N, ceil(cap / g), g], as the one-ray blocks (rays
    [N, 8, 1] in pack_block_rays' layout, order_g, n_cand); and overflow."""
    n = origins.shape[0]
    order, n_cand, _entry, overflow = _perray_candidates(
        accel, origins, directions, t_min, t_max, cap)
    n_cand = torch.where(overflow, 0, n_cand)
    g = group_size
    cap_pad = -(-cap // g) * g
    if cap_pad - cap:
        order = torch.nn.functional.pad(order, (0, cap_pad - cap))
    order_g = order.reshape(n, cap_pad // g, g)
    rays = pack_block_rays(origins[:, None, :], directions[:, None, :],
                           t_max[:, None], t_min)
    return (rays, order_g, n_cand), overflow


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


def _perray_stage(accel, group_size, tri_pack, t_min, any_hit, dev):
    """(stage for _cascade_stages, tri_pack) of a perray query: on the card
    a stage is one call of cuda_cascade.perray_stage, one launch of the
    stage kernel with the perray folds (tri_pack: pack_tris'); on the CPU
    its plain version, cuda_cascade.perray_stage_plain, over the plain
    eager sweeps above, PACKET_SWEEP_ELEMS elements a step (the results do
    not depend on the step)."""
    if _kernel_sweeps(dev):
        if tri_pack is None:
            tri_pack = cuda_ctiles.pack_tris(accel)
        return (lambda b, c, k, thr: cuda_cascade.perray_stage(
            tri_pack, b[0], b[1], b[2], c, k, thr)), tri_pack
    step = max(1, PACKET_SWEEP_ELEMS // (group_size * accel.cluster_size))

    def sweep(_pack, r, cid):
        # r [n, 8]: o, d, the window's end (closest: min(t_max, best t))
        parts = []
        for lo in range(0, r.shape[0], step):
            rs = r[lo:lo + step]
            args = (accel, rs[:, None, 0:3], rs[:, None, 3:6], rs[:, 6:7],
                    cid[lo:lo + step], t_min)
            parts.append(_packet_sweep_any(*args) if any_hit
                         else _packet_sweep_closest(*args))
        if any_hit:
            return (torch.cat(parts)[:, 0],)
        return tuple(torch.cat([p[i] for p in parts])[:, 0] for i in (0, 1))

    return (lambda b, c, k, thr: cuda_cascade.perray_stage_plain(
        tri_pack, b[0], b[1], b[2], c, k, thr, sweep=sweep)), tri_pack


def closest_hit_perray(accel: ClusterAccel, origins, directions, t_min,
                       t_max, cap: int = 64, group_size: int = 4,
                       fallback_block: int = 64,
                       tri_pack=None) -> PacketHit:
    """Closest hit with exact per-ray candidate lists (no ray blocking):
    the packet cascade's machinery with blocks of one ray, `group_size`
    candidates an iteration in id order, t_cap = min(t_max, best t). The
    tie rule is the packet cascade's: within a group of g * S slots the
    first slot at the minimum t wins, and a later group replaces the best
    only with a strictly smaller t. The cascade runs as _cascade_stages
    (min_blocks 1024), each stage one call of cuda_cascade.perray_stage's
    first-slot fold (on the card one launch of the stage kernel, tri_pack:
    pack_tris'; on the CPU the plain eager sweep, the reference's being XLA
    code). Rays with more than `cap` candidates complete through
    closest_hit_packets (blocks of fallback_block), so every ray is exact;
    the overflow count is one host read a call."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    blocks, overflow = _perray_setup(accel, origins, directions, t_min, t_max,
                                     cap, group_size)
    stage, tri_pack = _perray_stage(accel, group_size, tri_pack, t_min, False,
                                    dev)
    carry, blk_index = _cascade_stages(
        blocks,
        (torch.full((n, 1), INF, dtype=torch.float32, device=dev),
         torch.full((n, 1), -1, dtype=torch.int32, device=dev)),
        stage, min_blocks=1024)
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
    leaves the cascade once occluded. The cascade runs as
    closest_hit_perray's, each stage one call of
    cuda_cascade.perray_stage's any-hit fold. Rays with more than `cap`
    candidates complete through any_hit_packets (blocks of fallback_block;
    tri_pack as its)."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    blocks, overflow = _perray_setup(accel, origins, directions, t_min, t_max,
                                     cap, group_size)
    stage, tri_pack = _perray_stage(accel, group_size, tri_pack, t_min, True,
                                    dev)
    carry, blk_index = _cascade_stages(
        blocks, (torch.zeros((n, 1), dtype=torch.bool, device=dev),),
        stage, min_blocks=1024)
    occluded = _unpermute_blocks(carry[0], blk_index)[:, 0]

    fb = _perray_fallback(
        origins, directions, t_max, overflow, fallback_block,
        lambda o, d, tm: any_hit_packets(accel, o, d, t_min, tm,
                                         block_size=fallback_block,
                                         tri_pack=tri_pack))
    if fb is None:
        return occluded
    return torch.where(overflow, fb[:n], occluded)
