"""Core SoA data types as NamedTuples of tensors.

Counterpart of path_tracer_ai_tpu.core.types. Float tensors are float32,
integer ids int32; every tensor of one structure lives on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from path_tracer_ai_tpu_torch.device import resolve_device

# Material type codes (mirror MaterialType, material.hpp:6-10).
MATERIAL_DIFFUSE = 0
MATERIAL_SPECULAR = 1
MATERIAL_DIELECTRIC = 2

# Reference ray epsilon (ray.hpp:8) and bounce/shadow origin offsets.
RAY_TMIN = 1.0e-3
RAY_EPS = 1.0e-3
# Möller–Trumbore determinant epsilon (triangle.hpp:25).
MT_EPSILON = 1.0e-7
# Minimum light distance guard (renderer.hpp:263).
LIGHT_MIN_DIST = 1.0e-4

INF = float(np.inf)


class TrianglesSoA(NamedTuple):
    """v0/v1/v2, n0/n1/n2: [T,3] f32; uv0/uv1/uv2: [T,2] f32; mat_id: [T] i32."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]


class MaterialTable(NamedTuple):
    mtype: torch.Tensor      # [M] i32, MATERIAL_*
    albedo: torch.Tensor     # [M,3] f32
    roughness: torch.Tensor  # [M] f32
    metallic: torch.Tensor   # [M] f32
    ior: torch.Tensor        # [M] f32

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


class Lights(NamedTuple):
    position: torch.Tensor   # [L,3] f32
    color: torch.Tensor      # [L,3] f32
    intensity: torch.Tensor  # [L] f32

    @property
    def count(self) -> int:
        return self.position.shape[0]


class SceneData(NamedTuple):
    triangles: TrianglesSoA
    materials: MaterialTable
    lights: Lights


def f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32), device=device)


def triangles_from_numpy(
    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, device=None
) -> TrianglesSoA:
    """The ten arrays of a TrianglesSoA on `device` (None: the card)."""
    device = resolve_device(device)
    return TrianglesSoA(
        v0=f32(v0, device), v1=f32(v1, device), v2=f32(v2, device),
        n0=f32(n0, device), n1=f32(n1, device), n2=f32(n2, device),
        uv0=f32(uv0, device), uv1=f32(uv1, device), uv2=f32(uv2, device),
        mat_id=i32(mat_id, device),
    )
