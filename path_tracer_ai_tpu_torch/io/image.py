"""Image finalization: clamp -> gamma -> 8-bit -> PNG.

Mirrors Renderer::saveImage (src/renderer.cpp:5-21): clamp(c, 0, 1) **
(1/gamma), * 255, truncating cast to uint8. Row 0 becomes the top PNG row.
"""

from __future__ import annotations

import numpy as np

from path_tracer_ai_tpu_torch.io.png import write_png
from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def tonemap_to_u8(image: np.ndarray, gamma: float) -> np.ndarray:
    """[H,W,3] linear float -> [H,W,3] uint8 (renderer.cpp:9-16)."""
    img = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    img = np.power(img, 1.0 / gamma)
    return (img * 255.0).astype(np.uint8)


def save_image(path: str, image: np.ndarray, gamma: float) -> None:
    write_png(path, tonemap_to_u8(image, gamma))
    log.info("Image saved as: %s", path)
