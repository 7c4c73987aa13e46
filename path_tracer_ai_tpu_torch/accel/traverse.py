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

The sweep of one (block, cluster) pair is the cluster-tile kernel
(accel.cuda_ctiles.tile_sweep, T = block_size lanes, occluded =
tri != INT32_MAX): the same Möller–Trumbore arithmetic as _mt_sweep, with
no [blocks, rays, triangles] intermediate in device memory. The cascade's
loop conditions are host reads (`.item()`/nonzero), one per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
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
    mode="octorig": dead(1) | octant(3) | origin-Morton(21)
    """
    octant = (
        (directions[:, 0] < 0).to(torch.int64) * 4
        + (directions[:, 1] < 0).to(torch.int64) * 2
        + (directions[:, 2] < 0).to(torch.int64)
    )
    if mode == "octorig":
        ocell7 = morton3d(origins, accel.scene_min, accel.scene_max, bits=7)
        key = (octant << 21) | ocell7.to(torch.int64)
    elif mode == "dir":
        ones = torch.ones((3,), dtype=torch.float32, device=origins.device)
        dcell = morton3d(directions, -ones, ones, bits=3).to(torch.int64)
        ocell = morton3d(origins, accel.scene_min, accel.scene_max,
                         bits=6).to(torch.int64)
        key = (octant << 27) | (dcell << 18) | ocell
    else:
        raise ValueError(f"sort mode {mode!r} is not ported")
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


def _interval_slab(bmin, bmax, olo, ohi, dlo, dhi):
    """Interval-arithmetic slab bounds of ray blocks vs shared [K,3] boxes.

    olo/ohi/dlo/dhi: [B, 3]. Returns (lb, ub) [B, K]: for every member
    ray, slab entry >= lb and exit <= ub. torch.minimum/maximum propagate
    NaN exactly as jnp.minimum/maximum do in the reference."""
    nb = olo.shape[0]
    kdim = bmin.shape[0]
    dev = olo.device
    lb = torch.full((nb, kdim), -INF, dtype=torch.float32, device=dev)
    ub = torch.full((nb, kdim), INF, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for a in range(3):
        bl = bmin[None, :, a]
        bh = bmax[None, :, a]
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


def _cascade_traverse(block_arrays, carry, sweep_update, active_fn,
                      min_blocks: int = 32):
    """Cascaded block traversal: retire finished blocks, halve the slice.

    sweep_update(k, blocks, carry, idx) -> carry, where idx [n] i64 are the
    active blocks of the slice; active_fn(k, blocks, carry) -> [size] bool.
    Each stage runs until at most half its blocks are active (the last
    stage until none is), then gathers the active blocks to the front with
    ONE whole-array gather and continues on half the slice.
    Returns (carry, blk_index): blk_index[i] = original block at row i."""
    nb = block_arrays[0].shape[0]
    dev = block_arrays[0].device
    blk_index = torch.arange(nb, dtype=torch.int64, device=dev)
    full = list(block_arrays) + list(carry) + [blk_index]
    n_in = len(block_arrays)
    n_carry = len(carry)

    size = nb
    k = 0
    while True:
        blocks_sl = [a[:size] for a in full[:n_in]]
        carry_sl = [a[:size] for a in full[n_in:n_in + n_carry]]
        last_stage = size // 2 < min_blocks
        threshold = 0 if last_stage else size // 2
        while True:
            act = active_fn(k, blocks_sl, carry_sl)
            idx = torch.nonzero(act).squeeze(1)
            sync.note()
            if idx.numel() <= threshold:
                break
            carry_sl = sweep_update(k, blocks_sl, carry_sl, idx)
            k += 1
        for i in range(n_carry):
            j = n_in + i
            full[j] = torch.cat([carry_sl[i], full[j][size:]])
        if last_stage:
            break
        perm = torch.argsort((~act).to(torch.uint8), stable=True)
        row_idx = torch.cat([perm, torch.arange(size, nb, dtype=torch.int64,
                                                device=dev)])
        full = [a[row_idx] for a in full]
        size //= 2
    return full[n_in:n_in + n_carry], full[-1]


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
                    group_size: int = 8, tri_pack=None) -> torch.Tensor:
    """Occlusion query over a wave ([N] bool); N must be a multiple of
    block_size. Exact: a ray is occluded iff some triangle passes its
    Möller–Trumbore test within [t_min, t_max]."""
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
            accel, origins, directions, t_max, "dir")

    o_blk = origins.reshape(nb, block_size, 3)
    d_blk = directions.reshape(nb, block_size, 3)
    tmax_blk = t_max.reshape(nb, block_size)

    order, n_cand, _entry = _block_candidates(accel, o_blk, d_blk, tmax_blk)
    g = group_size
    c = accel.num_clusters
    c_pad = -(-c // g) * g
    if c_pad - c:
        order = torch.nn.functional.pad(order, (0, c_pad - c))
    order_g = order.reshape(nb, c_pad // g, g)
    max_k = c_pad // g - 1
    if tri_pack is None:
        tri_pack = cuda_ctiles.pack_tris(accel)
    rays = pack_block_rays(o_blk, d_blk, tmax_blk, t_min)

    def active_fn(k, blocks, carry):
        # Dead lanes (t_max < 0) count as resolved.
        tb, nc = blocks[0], blocks[1]
        resolved = carry[0] | (tb < 0.0)
        return (k * g < nc) & ~resolved.all(dim=1)

    def sweep_update(k, blocks, carry, idx):
        ordg, rp = blocks[2], blocks[3]
        (occ,) = carry
        cid = ordg[idx, min(k, max_k)]                  # [n_act, g]
        r_act = rp[idx]                                 # [n_act, 8, R]
        hit = torch.zeros((idx.numel(), block_size), dtype=torch.bool,
                          device=dev)
        for j in range(g):
            _t, tri = cuda_ctiles.tile_sweep(tri_pack, r_act,
                                             cid[:, j].contiguous())
            hit |= tri != cuda_ctiles.I32_MAX
        occ = occ.clone()
        occ[idx] |= hit
        return (occ,)

    carry, blk_index = _cascade_traverse(
        (tmax_blk, n_cand, order_g, rays),
        (torch.zeros((nb, block_size), dtype=torch.bool, device=dev),),
        sweep_update,
        active_fn,
    )
    out = _unpermute_blocks(carry[0], blk_index).reshape(n)
    if sort:
        res = torch.empty_like(out)
        res[perm] = out
        out = res
    return out
