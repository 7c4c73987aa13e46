"""Render configuration (counterpart of path_tracer_ai_tpu.config).

Defaults follow the reference CLI (src/main.cpp:15-24).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Settings shared by the oracle and wavefront engines."""

    width: int = 800
    height: int = 450
    samples_per_pixel: int = 100
    max_bounces: int = 5
    gamma: float = 2.2
    # "fixed" reproduces the reference CPU camera's hardcoded 16:9 viewport
    # (camera.hpp:22); "true" uses width/height.
    aspect_mode: str = "fixed"
    # None seeds from entropy, like the reference's std::random_device.
    seed: int | None = 0

    def aspect_ratio(self) -> float:
        if self.aspect_mode == "fixed":
            return 16.0 / 9.0
        return float(self.width) / float(self.height)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
