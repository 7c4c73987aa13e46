"""Ray/primitive intersection math (counterpart of core/geometry.py).

Möller–Trumbore (triangle.hpp:23-67) and the AABB slab test
(aabb.hpp:13-25), branchless and broadcasting over leading ray dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.core import vec
from path_tracer_ai_tpu_torch.core.types import MT_EPSILON


class TriHits(NamedTuple):
    t: torch.Tensor      # [..., T] hit distance (inf where invalid)
    u: torch.Tensor      # [..., T]
    v: torch.Tensor      # [..., T]
    valid: torch.Tensor  # [..., T] bool


def _bound(x):
    return x[..., None] if torch.is_tensor(x) and x.dim() else x


def moller_trumbore(origin, direction, v0, v1, v2, t_min, t_max) -> TriHits:
    """One ray batch [..., 3] against [T] triangles, with the reference's
    rejection tests: |a| > 1e-7, u in [0,1], v >= 0, u+v <= 1,
    t in [t_min, t_max]."""
    o = origin[..., None, :]
    d = direction[..., None, :]
    edge1 = v1 - v0
    edge2 = v2 - v0

    h = vec.cross(d, edge2)
    a = vec.dot(edge1, h)
    not_parallel = torch.abs(a) > MT_EPSILON
    f = 1.0 / torch.where(not_parallel, a, torch.ones_like(a))
    s = o - v0
    u = f * vec.dot(s, h)
    q = vec.cross(s, edge1)
    vv = f * vec.dot(d, q)
    t = f * vec.dot(edge2, q)

    valid = (
        not_parallel
        & (u >= 0.0) & (u <= 1.0)
        & (vv >= 0.0) & (u + vv <= 1.0)
        & (t >= _bound(t_min)) & (t <= _bound(t_max))
    )
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    return TriHits(t=t, u=u, v=vv, valid=valid)


def aabb_hit(origin, direction, bmin, bmax, t_min, t_max):
    """Slab test against [C] boxes -> (hit [..., C], entry t).

    The comparison-select update `lo = where(near > lo, near, lo)` keeps the
    running bound when a 0*inf product is NaN, like the C++
    `t0 > tMin ? t0 : tMin` (torch.maximum would propagate the NaN)."""
    o = origin[..., None, :]
    inv_d = 1.0 / direction[..., None, :]
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.where(inv_d < 0.0, t1, t0)
    far = torch.where(inv_d < 0.0, t0, t1)

    shape = near[..., 0].shape
    lo = torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32,
                                            device=near.device), shape)
    hi = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=near.device), shape)
    for axis in range(3):
        lo = torch.where(near[..., axis] > lo, near[..., axis], lo)
        hi = torch.where(far[..., axis] < hi, far[..., axis], hi)
    return hi > lo, lo


def triangle_aabbs(v0, v1, v2):
    """Per-triangle bounds (triangle.hpp:73-77): (bmin, bmax)."""
    bmin = torch.minimum(torch.minimum(v0, v1), v2)
    bmax = torch.maximum(torch.maximum(v0, v1), v2)
    return bmin, bmax


def triangle_centers(v0, v1, v2):
    """Triangle centroids (triangle.hpp:69-71)."""
    return (v0 + v1 + v2) / 3.0
