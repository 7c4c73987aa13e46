"""Numerical-validity checks (counterpart of utils/debug.py).

The reference's runtime guards are NaN/Inf checks with magenta sentinels
and console warnings (renderer.hpp:75-79, 112-123). Here:
- `validate_image`: a post-render audit of the frame (the CLI's
  --validate);
- `assert_finite`: a tensor check that logs a warning on a non-finite
  element. It reads a count back to the host, so nothing on the render
  path calls it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAGENTA = np.asarray([1.0, 0.0, 1.0], np.float32)


class ImageAudit(NamedTuple):
    finite: bool
    n_nan: int
    n_inf: int
    n_magenta: int   # invalid-sample sentinel pixels (renderer.hpp:78)
    n_negative: int


def validate_image(image: np.ndarray) -> ImageAudit:
    """Counts of NaN, Inf and negative components and of magenta pixels of a
    linear [H, W, 3] image; logs a warning when it is not clean."""
    img = np.asarray(image)
    nan = int(np.isnan(img).sum())
    inf = int(np.isinf(img).sum())
    magenta = int((np.abs(img - MAGENTA).max(axis=-1) < 1e-6).sum())
    neg = int((img < 0).sum())
    audit = ImageAudit(
        finite=(nan == 0 and inf == 0),
        n_nan=nan, n_inf=inf, n_magenta=magenta, n_negative=neg,
    )
    if not audit.finite or audit.n_magenta:
        log.warning(
            "Image audit: %d NaN, %d Inf, %d magenta sentinel px, %d negative",
            nan, inf, magenta, neg,
        )
    return audit


def assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Log a warning if `x` holds a non-finite element; returns `x`
    unchanged (the engines' masking does the semantic filtering)."""
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        log.warning("%d non-finite elements in %s", bad, name)
    return x
