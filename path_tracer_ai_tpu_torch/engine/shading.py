"""Shading semantics shared by the oracle and wavefront engines.

Counterpart of engine/shading.py: the reference CPU renderer's radiance
(renderer.hpp:129-301) recast from recursion into throughput form,
L += beta * direct; beta *= f, with per-material f:
    DIFFUSE    f = 2 * albedo * cos                 (renderer.hpp:187)
    SPECULAR   f = albedo * cos                     (renderer.hpp:211)
    DIELECTRIC f = 1, direct term not added         (renderer.hpp:245)
All functions are branchless masked-lane computations over [N] batches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from path_tracer_ai_tpu_torch.core import materials as mat_utils
from path_tracer_ai_tpu_torch.core import vec
from path_tracer_ai_tpu_torch.core.types import (
    LIGHT_MIN_DIST,
    MATERIAL_DIELECTRIC,
    MATERIAL_DIFFUSE,
    MATERIAL_SPECULAR,
    RAY_EPS,
    Lights,
    MaterialTable,
)

PI = mat_utils.PI

# occlude_fn(origins [K,3], directions [K,3], t_max [K]) -> occluded [K] bool
OccludeFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class MaterialLanes(NamedTuple):
    mtype: torch.Tensor      # [N] i32
    albedo: torch.Tensor     # [N,3]
    roughness: torch.Tensor  # [N]
    ior: torch.Tensor        # [N]


def gather_materials(table: MaterialTable, mat_id: torch.Tensor) -> MaterialLanes:
    # Out-of-range ids are clamped for the gather; bounce_step masks them.
    idx = mat_id.long().clamp(0, table.mtype.shape[0] - 1)
    return MaterialLanes(
        mtype=table.mtype[idx],
        albedo=table.albedo[idx],
        roughness=table.roughness[idx],
        ior=table.ior[idx],
    )


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def direct_lighting(lights: Lights, occlude_fn: OccludeFn, position, normal,
                    view_dir, mats: MaterialLanes, active) -> torch.Tensor:
    """calculateDirectLighting (renderer.hpp:252-301) over a lane batch.

    All L lights' shadow rays go to ONE occlusion query of L*N rays in
    light-major order (light l's rays are rows l*N .. l*N+N-1). Inactive
    lanes are pinned to a no-op query (origin 0, +x, t_max = -1), and so are
    pairs that contribute 0 either way (cos <= 0, dielectric lanes).
    Non-finite per-light contributions are dropped (renderer.hpp:295-297).
    """
    n_lanes = position.shape[0]
    n_lights = lights.position.shape[0]
    zero = _zero(position)

    position = torch.where(active[..., None], position, zero)
    normal = torch.where(active[..., None], normal, zero)

    lp = lights.position[:, None, :]                      # [L,1,3]
    lvec = lp - position[None, :, :]                      # [L,N,3]
    dist = vec.length(lvec)                               # [L,N]
    too_close = dist < LIGHT_MIN_DIST
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                          device=position.device)
    ldir = torch.where(
        active[None, :, None],
        lvec / torch.clamp(dist, min=1e-30)[..., None],
        unit_x,
    )

    shadow_origin = position + normal * RAY_EPS           # [N,3]
    so = torch.broadcast_to(shadow_origin[None], (n_lights, n_lanes, 3))

    cos_theta = torch.clamp(vec.dot(normal[None], ldir), min=0.0)  # [L,N]
    attenuation = lights.intensity[:, None] / (dist * dist)

    contributes = (
        active[None]
        & (cos_theta > 0.0)
        & (mats.mtype != MATERIAL_DIELECTRIC)[None]
    )
    t_max = torch.where(contributes, dist - RAY_EPS,
                        torch.full_like(dist, -1.0))      # (renderer.hpp:275)

    occluded = occlude_fn(
        so.reshape(-1, 3), ldir.reshape(-1, 3), t_max.reshape(-1)
    ).reshape(n_lights, n_lanes)

    # BRDF per material type (renderer.hpp:283-291).
    brdf_diffuse = mats.albedo / PI                              # [N,3]
    half = vec.normalize(ldir + view_dir[None])                  # [L,N,3]
    n_dot_h = torch.clamp(vec.dot(normal[None], half), min=0.0)  # [L,N]
    d_term = mat_utils.ggx_distribution(n_dot_h, mats.roughness[None])
    brdf_specular = mats.albedo[None] * d_term[..., None]        # [L,N,3]

    is_diffuse = mats.mtype == MATERIAL_DIFFUSE
    is_specular = mats.mtype == MATERIAL_SPECULAR
    brdf = torch.where(
        is_diffuse[None, :, None],
        brdf_diffuse[None],
        torch.where(is_specular[None, :, None], brdf_specular, zero),
    )

    contrib = lights.color[:, None, :] * brdf * (cos_theta * attenuation)[..., None]
    lit = active[None] & ~occluded & ~too_close
    finite = torch.isfinite(contrib).all(dim=-1)          # isValidColor per light
    contrib = torch.where((lit & finite)[..., None], contrib, zero)
    out = contrib[0]
    for l in range(1, n_lights):  # the light sum in light order
        out = out + contrib[l]
    return out


class BsdfSample(NamedTuple):
    direction: torch.Tensor    # [N,3]
    origin: torch.Tensor       # [N,3]
    throughput: torch.Tensor   # [N,3]
    adds_direct: torch.Tensor  # [N] bool


def sample_bsdf(ray_dir, position, normal, mats: MaterialLanes,
                sphere_sample, fresnel_u) -> BsdfSample:
    """The material switch of tracePath (renderer.hpp:166-247), branchless.
    One sphere draw serves the diffuse hemisphere and the specular
    perturbation; `fresnel_u` drives the dielectric reflect/refract choice."""
    # DIFFUSE (renderer.hpp:167-188)
    hemi = torch.where(
        (vec.dot(sphere_sample, normal) < 0.0)[..., None],
        -sphere_sample, sphere_sample,
    )
    cos_d = vec.dot(hemi, normal)
    f_diffuse = 2.0 * mats.albedo * cos_d[..., None]

    # SPECULAR (renderer.hpp:190-212)
    refl = vec.reflect(ray_dir, normal)
    perturbed = vec.normalize(refl + mats.roughness[..., None] * sphere_sample)
    spec_dir = torch.where((mats.roughness > 0.0)[..., None], perturbed, refl)
    cos_s = vec.dot(spec_dir, normal)
    f_specular = mats.albedo * cos_s[..., None]

    # DIELECTRIC (renderer.hpp:214-246)
    cos_i = vec.dot(-ray_dir, normal)
    entering = cos_i >= 0.0
    n_or = torch.where(entering[..., None], normal, -normal)
    cos_abs = torch.abs(cos_i)
    one = torch.ones_like(mats.ior)
    etai = torch.where(entering, one, mats.ior)
    etat = torch.where(entering, mats.ior, one)
    ratio = etai / etat
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_abs * cos_abs, min=0.0))
    tir = ratio * sin_theta > 1.0
    f0 = (etai - etat) / (etai + etat)  # unsquared, like renderer.hpp:230
    fresnel = mat_utils.schlick_fresnel(cos_abs, f0)
    choose_reflect = tir | (fresnel_u < fresnel)
    diel_dir = torch.where(
        choose_reflect[..., None],
        vec.reflect(ray_dir, n_or),
        vec.refract(ray_dir, n_or, ratio),
    )

    is_diffuse = (mats.mtype == MATERIAL_DIFFUSE)[..., None]
    is_specular = (mats.mtype == MATERIAL_SPECULAR)[..., None]
    is_dielectric = (mats.mtype == MATERIAL_DIELECTRIC)[..., None]

    direction = torch.where(
        is_diffuse, hemi, torch.where(is_specular, spec_dir, diel_dir)
    )
    throughput = torch.where(
        is_diffuse, f_diffuse,
        torch.where(is_specular, f_specular, torch.ones_like(f_diffuse)),
    )
    offset_n = torch.where(is_dielectric, n_or, normal)
    origin = position + offset_n * RAY_EPS
    return BsdfSample(direction=direction, origin=origin,
                      throughput=throughput, adds_direct=~is_dielectric[..., 0])
