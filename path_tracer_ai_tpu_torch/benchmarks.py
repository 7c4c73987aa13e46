"""The five benchmark configurations of BASELINE.md and the RMSE harness
(counterpart of benchmarks.py).

  cpu-ref     800x450,  10 spp,  5 bounces  (reference --mode cpu default)
  cornell     512x512,  64 spp,  5 bounces  (diffuse GI sanity)
  dielectric 1280x720, 100 spp,  8 bounces  (glass-enabled blob)
  gpu-parity 1920x1080, 100 spp, 5 bounces  (reference README GPU config)
  4k         3840x2160, 1024 spp, 16 bounces, progressive + tiled

The reference's model is not shipped, so the blob configurations render the
procedural stand-in (scene.procgen.write_obj) through the OBJ loader.
Everything runs on the card unless a caller passes device="cpu". The 4k
configuration shards the frame over 8 devices (wavefront.render's
tile_devices, capped at the visible cards: one H100 renders it as a 1x1
mesh; with device="cpu", a mesh of 8 virtual CPU entries).

RMSE methodology: the oracle engine holds the CPU reference's semantics;
`rmse_vs_oracle` renders both engines at equal spp with DIFFERENT seeds,
so an unbiased fast path agrees with the oracle within Monte-Carlo noise.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np

from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class BenchConfig:
    name: str
    settings: RenderSettings
    scene_kind: str  # "blob" | "cornell"
    dielectric: bool = False
    progressive: bool = False
    tile_devices: int = 0


def get_configs(scale: float = 1.0):
    """The five configurations; `scale` < 1 shrinks spp for smoke runs."""
    s = lambda spp: max(1, int(spp * scale))
    return {
        "cpu-ref": BenchConfig(
            "cpu-ref", RenderSettings(800, 450, s(10), 5), "blob"),
        "cornell": BenchConfig(
            "cornell", RenderSettings(512, 512, s(64), 5), "cornell"),
        "dielectric": BenchConfig(
            "dielectric", RenderSettings(1280, 720, s(100), 8), "blob",
            dielectric=True),
        "gpu-parity": BenchConfig(
            "gpu-parity", RenderSettings(1920, 1080, s(100), 5), "blob"),
        "4k": BenchConfig(
            "4k", RenderSettings(3840, 2160, s(1024), 16), "blob",
            progressive=True, tile_devices=8),
    }


def build_config_scene(cfg: BenchConfig, subdivisions: int = 6, device=None):
    """(scene, camera) of a configuration on `device` (None: the card)."""
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    device = resolve_device(device)
    if cfg.scene_kind == "cornell":
        from path_tracer_ai_tpu_torch.scene.cornell import build_cornell_scene

        return build_cornell_scene(device=device)

    from path_tracer_ai_tpu_torch.scene.procgen import write_obj
    from path_tracer_ai_tpu_torch.scene.scene import build_scene

    with tempfile.TemporaryDirectory(prefix="ptbench_") as d:
        obj = write_obj(os.path.join(d, "blob.obj"), subdivisions=subdivisions)
        scene = build_scene(obj, enable_dielectrics=cfg.dielectric,
                            device=device)
    return scene, default_camera(device)


def run_config(name: str, scale: float = 1.0, subdivisions: int = 6,
               checkpoint_path: Optional[str] = None, device=None):
    """Render one configuration on the wavefront engine -> (image, stats)."""
    from path_tracer_ai_tpu_torch.engine import wavefront

    cfg = get_configs(scale)[name]
    scene, camera = build_config_scene(cfg, subdivisions, device)
    stats = wavefront.RenderStats()
    t0 = time.perf_counter()
    img = wavefront.render(
        scene, camera, cfg.settings,
        checkpoint_path=checkpoint_path,
        checkpoint_every=1 if cfg.progressive else 0,
        tile_devices=cfg.tile_devices or None, stats=stats, device=device,
    )
    log.info("[%s] %.2fs, %.1f Mrays/s", name, time.perf_counter() - t0,
             stats.mrays_per_s)
    return img, stats


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Relative RMSE in linear radiance (the BASELINE < 1% criterion)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = max(np.sqrt(np.mean(a**2)), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)) / denom)


def rmse_vs_oracle(scene, camera, settings: RenderSettings,
                   device=None) -> float:
    """Wavefront (seed s) vs oracle (seed s + 1) relative RMSE at equal spp."""
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront

    img_w = wavefront.render(scene, camera, settings, device=device)
    img_o = oracle.render(scene, camera,
                          settings.replace(seed=(settings.seed or 0) + 1),
                          device=device)
    return rmse(img_w, img_o)
