"""Per-ray slab test of the K-slot traversal (accel/kslots.py, the part the
main path runs: `_ray_slab`, used by the ctiles cull)."""

from __future__ import annotations

import torch

INF = float("inf")


def _ray_slab(bmin, bmax, o, d, lo0, hi0):
    """Per-ray inclusive slab test: [N,3] rays vs [K,3] boxes -> [N, K] bool.

    lo0/hi0: [N] initial interval (t_min, per-ray t_max). Inclusive bounds
    (hi >= lo) keep flat AABBs in. A 0*inf NaN (origin exactly on a slab
    plane of an axis-parallel ray) must not exclude: torch.minimum/maximum
    propagate it, so it is replaced by the identity bound of that axis."""
    inv = 1.0 / d
    o_ = o[:, None, :]
    inv_ = inv[:, None, :]
    t0 = (bmin[None] - o_) * inv_
    t1 = (bmax[None] - o_) * inv_
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    near = torch.where(torch.isnan(near), -INF, near)
    far = torch.where(torch.isnan(far), INF, far)
    lo = torch.maximum(near.amax(dim=-1), lo0[:, None])
    hi = torch.minimum(far.amin(dim=-1), hi0[:, None])
    return hi >= lo
