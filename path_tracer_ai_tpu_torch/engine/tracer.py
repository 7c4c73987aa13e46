"""The bounce loop: reference tracePath semantics over lane batches.

Counterpart of engine/tracer.py. The traversal backend is injected:
brute force for the oracle, the cluster traversal for the wavefront
engine. See engine.shading for the throughput derivation.
"""

from __future__ import annotations

from typing import Callable

import torch

from path_tracer_ai_tpu_torch.core import sampling, threefry
from path_tracer_ai_tpu_torch.core.types import RAY_TMIN, SceneData
from path_tracer_ai_tpu_torch.engine import intersect
from path_tracer_ai_tpu_torch.engine.shading import (
    direct_lighting,
    gather_materials,
    sample_bsdf,
)

# closest_fn(origins, directions, t_min, t_max) -> (hit, t, tri)-like
# occlude_fn(origins, directions, t_max) -> [K] bool
ClosestFn = Callable[..., object]
OccludeFn = Callable[..., torch.Tensor]

_MAGENTA = (1.0, 0.0, 1.0)


def bounce_step(scene: SceneData, closest_fn: ClosestFn, occlude_fn: OccludeFn,
                o, d, beta, radiance, alive, keys, depth,
                rr_start: int = 0, rr_floor: float = 0.05):
    """ONE shading vertex of tracePath for a lane batch.

    keys: [N, 2] per-lane stream keys; the RNG draws of this vertex depend
    only on (key, depth, purpose), so scheduling never changes a sample.
    depth: an int (a wave, every lane at one depth) or an int64 [N] tensor
    (the pool scheduler, each lane at its own depth).
    rr_start >= 1 (RenderSettings.rr_start): a vertex of depth >= rr_start
    roulettes its continuation on the updated throughput, survival
    p = clamp(max(beta), rr_floor, 1) then beta /= p, drawn on the TAG_RR
    stream of (lane, depth); with a depth tensor the gate is per lane. An
    int depth below rr_start (and rr_start 0) runs no op of it, which gives
    the same bits as a roulette no lane enters.
    Returns (o, d, beta, radiance, alive, n_closest, n_shadow); the counts
    are 0-dim tensors (no host sync here).
    """
    tris = scene.triangles
    n_lights = scene.lights.position.shape[0]

    # Dead lanes carry t_max = -1 < t_min: every traversal test fails.
    lane_tmax = torch.where(alive, float("inf"), -1.0).to(torch.float32)
    ch = closest_fn(o, d, RAY_TMIN, lane_tmax)
    safe_tri = torch.clamp(ch.tri, min=0)  # the cluster backends use -1 on miss
    attrs = intersect.hit_attributes(tris, o, d, ch.t, safe_tri)
    active = alive & ch.hit

    # Invalid material -> magenta from this vertex, path ends
    # (renderer.hpp:142-157).
    n_materials = scene.materials.mtype.shape[0]
    bad_mat = active & ((attrs.mat_id < 0) | (attrs.mat_id >= n_materials))
    magenta = torch.tensor(_MAGENTA, dtype=torch.float32, device=o.device)
    radiance = radiance + torch.where(bad_mat[..., None], beta * magenta,
                                      torch.zeros((), device=o.device))
    active = active & ~bad_mat
    mats = gather_materials(scene.materials, attrs.mat_id)

    # RNG: one sub-stream per (lane, bounce, purpose).
    kb = threefry.fold_in(keys, depth)
    sphere = sampling.uniform_sphere(threefry.fold_in(kb, sampling.TAG_BSDF))
    fresnel_u = threefry.uniform(threefry.fold_in(kb, sampling.TAG_FRESNEL))

    n_shadow = n_lights * active.sum()
    direct = direct_lighting(
        scene.lights, occlude_fn, attrs.position, attrs.normal, -d, mats, active
    )
    # Whole-sum isValidColor(directLight) (renderer.hpp:161-163).
    direct_ok = torch.isfinite(direct).all(dim=-1)
    active = active & direct_ok

    bs = sample_bsdf(d, attrs.position, attrs.normal, mats, sphere, fresnel_u)

    add = (active & bs.adds_direct)[..., None]
    zero = torch.zeros((), device=o.device)
    radiance = radiance + torch.where(add, beta * direct, zero)
    act = active[..., None]
    beta = torch.where(act, beta * bs.throughput, beta)
    o = torch.where(act, bs.origin, o)
    d = torch.where(act, bs.direction, d)

    per_lane = torch.is_tensor(depth)
    if rr_start and (per_lane or depth >= rr_start):
        u_rr = threefry.uniform(threefry.fold_in(kb, sampling.TAG_RR))
        p = torch.clamp(beta.amax(dim=-1), rr_floor, 1.0)
        # an int depth >= rr_start: every active lane roulettes
        roulette = active & (depth >= rr_start) if per_lane else active
        survive = roulette & (u_rr < p)
        beta = torch.where(survive[..., None], beta / p[..., None], beta)
        active = active & (~roulette | survive) if per_lane else survive

    n_closest = alive.sum()
    return o, d, beta, radiance, active, n_closest, n_shadow


def trace_paths(scene: SceneData, origins, directions, keys, max_bounces: int,
                closest_fn: ClosestFn, occlude_fn: OccludeFn,
                rr_start: int = 0):
    """Returns (radiance [N,3], valid [N], (n_closest, n_shadow))."""
    n = origins.shape[0]
    dev = origins.device
    o, d = origins, directions
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    n_closest = torch.zeros((), dtype=torch.int64, device=dev)
    n_shadow = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_bounces):
        o, d, beta, radiance, alive, nc, ns = bounce_step(
            scene, closest_fn, occlude_fn, o, d, beta, radiance, alive, keys,
            depth, rr_start=rr_start,
        )
        n_closest = n_closest + nc
        n_shadow = n_shadow + ns
    # isValidColor on the whole sample (renderer.hpp:69-73).
    valid = torch.isfinite(radiance).all(dim=-1)
    return radiance, valid, (n_closest, n_shadow)


def brute_force_backend(scene: SceneData, tri_chunk: int = 512):
    """Exact traversal backend of the oracle engine."""
    tris = scene.triangles

    def closest(o, d, t_min, t_max):
        return intersect.closest_hit(tris, o, d, t_min, t_max,
                                     chunk_size=tri_chunk)

    def occlude(o, d, t_max):
        return intersect.any_hit(tris, o, d, RAY_TMIN, t_max,
                                 chunk_size=tri_chunk)

    return closest, occlude
