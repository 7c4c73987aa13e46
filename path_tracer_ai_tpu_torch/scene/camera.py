"""Pinhole camera (counterpart of scene/camera.py; camera.hpp:7-44).

Reproduces the reference's basis construction and ray generation,
including its quirk: the CPU camera hardcodes a 16:9 viewport whatever the
image resolution (camera.hpp:22); RenderSettings.aspect_mode picks it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from path_tracer_ai_tpu_torch.core import vec
from path_tracer_ai_tpu_torch.device import resolve_device


class Camera(NamedTuple):
    position: torch.Tensor  # [3]
    forward: torch.Tensor   # [3]
    right: torch.Tensor     # [3]
    up: torch.Tensor        # [3]
    fov_deg: torch.Tensor   # [] scalar

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in self))


def make_camera(position, target, up, fov_deg, device=None) -> Camera:
    """Basis construction mirroring camera.hpp:9-16 (numpy, host-side), on
    `device` (None: the card)."""
    device = resolve_device(device)
    position = np.asarray(position, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)

    forward = target - position
    forward = forward / np.linalg.norm(forward)
    upn = up / np.linalg.norm(up)
    right = np.cross(forward, upn)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)  # NOT renormalized (camera.hpp:15)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(position=t(position), forward=t(forward), right=t(right),
                  up=t(true_up), fov_deg=t(np.float32(fov_deg)))


def default_camera(device=None) -> Camera:
    """The hardcoded camera of the reference CLI (src/main.cpp:46-51), on
    `device` (None: the card)."""
    return make_camera(
        position=(0.0, 2.0, 5.0), target=(0.0, 1.8, 0.0),
        up=(0.0, 1.0, 0.0), fov_deg=45.0, device=device,
    )


def get_rays(camera: Camera, u: torch.Tensor, v: torch.Tensor, aspect: float):
    """Normalized camera rays (camera.hpp:18-29) for viewport coords u, v
    [...] -> (origins [..., 3], directions [..., 3])."""
    theta = camera.fov_deg * (math.pi / 180.0)
    # tan through f64, rounded once to f32 (as XLA's is at the default 45
    # degrees; torch's f32 tan on the CPU is an ulp off there): the f32 half
    # angle is written as f64 and the f64 tangent as f32 by the kernels
    # themselves (out=), so the card runs the two kernels it ran before.
    half = torch.div(theta, 2.0,
                     out=theta.new_empty(theta.shape, dtype=torch.float64))
    h = torch.tan(half, out=torch.empty_like(theta))
    viewport_height = 2.0 * h
    viewport_width = viewport_height * aspect

    horizontal = viewport_width * camera.right
    vertical = viewport_height * camera.up
    lower_left = -horizontal / 2.0 - vertical / 2.0 + camera.forward

    d = lower_left + u[..., None] * horizontal + v[..., None] * vertical
    directions = vec.normalize(d)
    origins = torch.broadcast_to(camera.position, directions.shape)
    return origins, directions


def pixel_uv(x, y, width: int, height: int):
    """The deterministic part of the pixel -> viewport mapping
    (renderer.hpp:63-64): the reference divides by (dim - 1), not dim. The
    caller adds the jitter before get_rays."""
    return x / (width - 1), y / (height - 1)
