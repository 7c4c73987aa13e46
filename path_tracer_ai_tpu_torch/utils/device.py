"""Device buffer helpers (counterpart of utils/device.py; the reference's
CUDABuffer role, cuda_utils.hpp:56-92).

PyTorch's caching allocator owns allocation and lifetime, so this is a thin,
observable layer over placement: upload / download, scene placement with a
size report, and the allocator's live / peak bytes. Device selection itself
is `path_tracer_ai_tpu_torch.device.resolve_device`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.scene.scene import scene_to
from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def nbytes_of(tree: Any) -> int:
    """Bytes of every tensor or array in a (nested) tuple, list or dict."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, (tuple, list)):
        return sum(nbytes_of(x) for x in tree)
    if isinstance(tree, dict):
        return sum(nbytes_of(x) for x in tree.values())
    return 0


def upload(array: np.ndarray, device=None) -> torch.Tensor:
    """Host -> device (None: the card), the cudaMemcpyHostToDevice role."""
    return torch.as_tensor(np.asarray(array), device=resolve_device(device))


def download(tensor: torch.Tensor) -> np.ndarray:
    """Device -> host; waits for the tensor's producers."""
    return tensor.detach().cpu().numpy()


def scene_to_device(scene, device=None):
    """A SceneData with every tensor on `device` (None: the card), logging
    the size placed (the uploadScene report, optix_renderer.cu:383-418)."""
    placed = scene_to(scene, resolve_device(device))
    log.info("Scene uploaded: %d triangles, %.2f MB device memory",
             scene.triangles.count, nbytes_of(placed) / 1e6)
    return placed


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live, peak and total bytes of a CUDA device (None: the card) from
    torch.cuda.memory_stats, under the JAX package's key names; {} for the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }
