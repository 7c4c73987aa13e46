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


def fold_all(base_key: torch.Tensor, *vals) -> torch.Tensor:
    """fold_in(...fold_in(base_key, v0)..., vn) (oracle._fold_all)."""
    k = base_key
    for v in vals:
        k = threefry.fold_in(k, v)
    return k
