"""Brute-force ray/scene intersection (counterpart of engine/intersect.py).

The oracle engine's exact traversal: nearest hit over all triangles with
t in [t_min, t_max], ties to the lowest triangle index. Triangles are
swept in chunks, so peak memory is R x CHUNK.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_ai_tpu_torch.core import vec
from path_tracer_ai_tpu_torch.core.geometry import moller_trumbore
from path_tracer_ai_tpu_torch.core.types import TrianglesSoA

_BIG = torch.iinfo(torch.int32).max
CHUNK = 512  # triangles per step ([R, 512] temporaries)


class ClosestHit(NamedTuple):
    hit: torch.Tensor  # [R] bool
    t: torch.Tensor    # [R] f32 (inf on miss)
    tri: torch.Tensor  # [R] i32 (0 on miss)


def closest_hit(tris: TrianglesSoA, origins, directions, t_min, t_max
                ) -> ClosestHit:
    r = origins.shape[0]
    dev = origins.device
    best_t = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((r,), dtype=torch.int32, device=dev)
    for lo in range(0, tris.v0.shape[0], CHUNK):
        hi = min(lo + CHUNK, tris.v0.shape[0])
        hits = moller_trumbore(origins, directions, tris.v0[lo:hi],
                               tris.v1[lo:hi], tris.v2[lo:hi], t_min, t_max)
        ct = hits.t.amin(dim=-1)
        idx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        ci = torch.where(hits.t == ct[:, None], idx, _BIG).amin(dim=-1)
        closer = ct < best_t  # strict: an earlier chunk keeps ties
        best_t = torch.where(closer, ct, best_t)
        best_i = torch.where(closer, ci, best_i)
    return ClosestHit(hit=torch.isfinite(best_t), t=best_t, tri=best_i)


def any_hit(tris: TrianglesSoA, origins, directions, t_min, t_max
            ) -> torch.Tensor:
    """Occlusion query: any triangle with t in [t_min, t_max]."""
    occluded = torch.zeros((origins.shape[0],), dtype=torch.bool,
                           device=origins.device)
    for lo in range(0, tris.v0.shape[0], CHUNK):
        hi = min(lo + CHUNK, tris.v0.shape[0])
        hits = moller_trumbore(origins, directions, tris.v0[lo:hi],
                               tris.v1[lo:hi], tris.v2[lo:hi], t_min, t_max)
        occluded |= hits.valid.any(dim=-1)
    return occluded


class HitAttributes(NamedTuple):
    position: torch.Tensor  # [R,3]
    normal: torch.Tensor    # [R,3] interpolated, normalized
    uv: torch.Tensor        # [R,2]
    mat_id: torch.Tensor    # [R] i32


def hit_attributes(tris: TrianglesSoA, origins, directions, t, tri_idx
                   ) -> HitAttributes:
    """Barycentric interpolation at a known hit (triangle.hpp:60-66).
    Garbage on miss lanes; callers mask."""
    idx = tri_idx.long()
    g = lambda a: a[idx]
    v0, v1, v2 = g(tris.v0), g(tris.v1), g(tris.v2)

    edge1 = v1 - v0
    edge2 = v2 - v0
    h = vec.cross(directions, edge2)
    a = vec.dot(edge1, h)
    f = 1.0 / torch.where(torch.abs(a) > 0, a, torch.ones_like(a))
    s = origins - v0
    u = f * vec.dot(s, h)
    q = vec.cross(s, edge1)
    v = f * vec.dot(directions, q)
    w = 1.0 - u - v

    normal = vec.normalize(
        w[..., None] * g(tris.n0) + u[..., None] * g(tris.n1)
        + v[..., None] * g(tris.n2)
    )
    uv = (w[..., None] * g(tris.uv0) + u[..., None] * g(tris.uv1)
          + v[..., None] * g(tris.uv2))
    position = origins + t[..., None] * directions  # Ray::at (ray.hpp:14-16)
    return HitAttributes(position=position, normal=normal, uv=uv,
                         mat_id=g(tris.mat_id))
