"""Oracle engine: the reference CPU renderer's semantics (engine/oracle.py).

Renderer::render + tracePath (renderer.hpp:40-301) in batch form: pixel
chunks, a sample loop per chunk, the throughput bounce loop with the
exact brute-force traversal, per-sample validity filtering and magenta
for pixels with no valid sample. It is the same-seed reference that the
wavefront engine is held against, on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core import sampling, threefry
from path_tracer_ai_tpu_torch.core.types import SceneData
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.engine import tracer
from path_tracer_ai_tpu_torch.scene.camera import Camera, get_rays
from path_tracer_ai_tpu_torch.scene.scene import scene_to
from path_tracer_ai_tpu_torch.utils.logging import get_logger, render_banner

log = get_logger(__name__)

MAGENTA = np.asarray([1.0, 0.0, 1.0], np.float32)  # invalid-pixel sentinel
CHUNK_PIXELS = 16384  # pixels per batch

_fold_all = sampling.fold_all


def resolve_seed(settings: RenderSettings) -> int:
    seed = settings.seed
    if seed is None:
        seed = int.from_bytes(np.random.bytes(4), "little")
    return seed


def camera_rays(camera: Camera, keys, xs, ys, w: int, h: int, aspect: float):
    """Jittered primary rays for per-lane keys (TAG_PIXEL_JITTER stream)."""
    kj = threefry.fold_in(keys, sampling.TAG_PIXEL_JITTER)
    jitter = threefry.uniform(kj, (2,))
    u = (xs.to(torch.float32) + jitter[:, 0]) / (w - 1)
    v = (ys.to(torch.float32) + jitter[:, 1]) / (h - 1)
    return get_rays(camera, u, v, aspect)


def finish_image(acc: np.ndarray, cnt: np.ndarray, w: int, h: int) -> np.ndarray:
    """Average valid samples; magenta where none was valid (renderer.hpp:75-79)."""
    safe_cnt = np.maximum(cnt, 1)[:, None].astype(np.float32)
    img = acc / safe_cnt
    img = np.where((cnt > 0)[:, None], img, MAGENTA[None, :])
    return img.reshape(h, w, 3)


def render(scene: SceneData, camera: Camera, settings: RenderSettings,
           device=None) -> np.ndarray:
    """Full-frame render -> linear [H, W, 3] float32 (numpy)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    camera = camera.to(dev)
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    aspect = settings.aspect_ratio()
    render_banner(log, settings)
    base_key = threefry.key(resolve_seed(settings), device=dev)
    closest, occlude = tracer.brute_force_backend(scene)

    npix = w * h
    chunk = min(CHUNK_PIXELS, npix)
    acc = np.zeros((npix, 3), np.float32)
    cnt = np.zeros((npix,), np.int32)
    for ci in range(math.ceil(npix / chunk)):
        lo = ci * chunk
        hi = min(lo + chunk, npix)
        pix = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        xs, ys = pix % w, pix // w
        a = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
        c = torch.zeros((hi - lo,), dtype=torch.int32, device=dev)
        for s in range(spp):
            keys = _fold_all(base_key, pix, s)
            o, d = camera_rays(camera, keys, xs, ys, w, h, aspect)
            radiance, valid, _ = tracer.trace_paths(
                scene, o, d, keys, settings.max_bounces, closest, occlude
            )
            a = a + torch.where(valid[..., None], radiance,
                                torch.zeros((), device=dev))
            c = c + valid.to(torch.int32)
        acc[lo:hi] = a.cpu().numpy()
        cnt[lo:hi] = c.cpu().numpy()
    return finish_image(acc, cnt, w, h)
