"""Morton (Z-order) codes (accel/morton.py): host codes (numpy uint32) for
the morton cluster build, device codes for ray sort keys.

The device codes run on int32 with masks in place of JAX's uint32
arithmetic: a 9-bit-per-axis code fills 27 bits, so no value reaches the
sign bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _part1by2_np(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (numpy uint32)."""
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d_np(points: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
                bits: int = 10):
    """30-bit Morton codes (uint32) for [N,3] points within [bmin, bmax]."""
    extent = np.maximum(bmax - bmin, 1e-12)
    q = np.clip((points - bmin) / extent, 0.0, 1.0 - 1e-7)
    scale = float(1 << bits)
    cells = np.minimum((q * scale).astype(np.uint32), (1 << bits) - 1)
    return (
        (_part1by2_np(cells[:, 0]) << 2)
        | (_part1by2_np(cells[:, 1]) << 1)
        | _part1by2_np(cells[:, 2])
    )


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(points: torch.Tensor, bmin, bmax, bits: int = 9) -> torch.Tensor:
    """Device Morton codes ([..., 3] f32 points -> int32), <= 10 bits/axis."""
    extent = torch.clamp(bmax - bmin, min=1e-12)
    q = torch.clamp((points - bmin) / extent, 0.0, 1.0 - 1e-7)
    cells = torch.clamp((q * float(1 << bits)).to(torch.int32),
                        max=(1 << bits) - 1)
    return (
        (_part1by2(cells[..., 0]) << 2)
        | (_part1by2(cells[..., 1]) << 1)
        | _part1by2(cells[..., 2])
    )
