"""BRDF helpers (mirrors MaterialUtils, material.hpp:20-58)."""

from __future__ import annotations

import math

import torch

PI = math.pi


def schlick_fresnel(cos_theta, f0):
    """Schlick approximation (material.hpp:21-26). The reference passes
    F0 = (etai-etat)/(etai+etat) UNSQUARED; callers reproduce that."""
    x = 1.0 - cos_theta
    x5 = (x * x) * (x * x) * x
    return f0 + (1.0 - f0) * x5


def ggx_distribution(n_dot_h, roughness):
    """GGX/Trowbridge-Reitz NDF (material.hpp:28-42)."""
    r = torch.clamp(roughness, 0.0, 1.0)
    alpha = r * r
    alpha2 = alpha * alpha
    ndh2 = n_dot_h * n_dot_h
    denom = ndh2 * (alpha2 - 1.0) + 1.0
    d = alpha2 / (PI * denom * denom)
    return torch.where(denom <= 0.0, torch.zeros_like(d), d)


def geometry_schlick_ggx(n_dot_v, roughness):
    """Schlick-GGX geometry term (material.hpp:44-51); API parity only."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    denom = n_dot_v * (1.0 - k) + k
    return torch.where(denom <= 0.0, torch.zeros_like(denom), n_dot_v / denom)


def geometry_smith(n_dot_v, n_dot_l, roughness):
    """Smith geometry term (material.hpp:53-57); API parity only."""
    return geometry_schlick_ggx(n_dot_v, roughness) * geometry_schlick_ggx(
        n_dot_l, roughness
    )
