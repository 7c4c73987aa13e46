"""Monte-Carlo sampling on the counter-based streams of core.threefry.

Counterpart of path_tracer_ai_tpu.core.sampling. Keys are derived as
fold_in chains over (pixel, sample, bounce, purpose), so every lane draws
from its own reproducible stream, independent of scheduling.
"""

from __future__ import annotations

import torch

from path_tracer_ai_tpu_torch.core import threefry, vec

# Purpose tags for key folding (draws for different uses never collide).
TAG_PIXEL_JITTER = 0
TAG_BSDF = 1
TAG_FRESNEL = 2
TAG_RR = 3


def uniform_sphere(keys: torch.Tensor) -> torch.Tensor:
    """One uniform direction per key [..., 2] -> [..., 3]: a normalized
    isotropic Gaussian (equal in distribution to renderer.hpp:308-319)."""
    return vec.safe_normalize(threefry.normal(keys, (3,)))


def uniform_hemisphere(keys: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """One uniform direction per key [..., 2] in the hemisphere around
    `normal` [..., 3] (randomHemisphereDirection, renderer.hpp:303-306): the
    sphere sample, flipped where it points below the surface (dot < 0;
    dot == 0 is kept as it is)."""
    d = uniform_sphere(keys)
    flip = vec.dot(d, normal) < 0.0
    return torch.where(flip[..., None], -d, d)


def sample_key(base_key: torch.Tensor, pixel_idx, sample_idx) -> torch.Tensor:
    """The stream of one (pixel, sample): fold_in(fold_in(base, pixel),
    sample), bit-equal to the reference's key data."""
    return threefry.fold_in(threefry.fold_in(base_key, pixel_idx), sample_idx)


def bounce_key(sample_key_: torch.Tensor, depth, tag) -> torch.Tensor:
    """The sub-stream of one (bounce, purpose) of a sample stream."""
    return threefry.fold_in(threefry.fold_in(sample_key_, depth), tag)


def fold_all(base_key: torch.Tensor, *vals) -> torch.Tensor:
    """fold_in(...fold_in(base_key, v0)..., vn) (oracle._fold_all)."""
    k = base_key
    for v in vals:
        k = threefry.fold_in(k, v)
    return k
