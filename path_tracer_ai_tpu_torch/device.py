"""Device selection for the port's entry points.

Entry points take `device=None`, which means `cuda`. There is no silent
move to the CPU: without a GPU, `resolve_device(None)` raises, and the CPU
runs only when a caller asks for it by name (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev
