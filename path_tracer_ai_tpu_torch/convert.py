"""Carries the JAX package's state across as numpy arrays.

With these, a test runs both packages on the same scene, accel, camera and
key bits. Every function takes plain numpy arrays (`np.asarray` of the
JAX arrays), never JAX objects, so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.core.types import (
    Lights,
    MaterialTable,
    SceneData,
    triangles_from_numpy,
)
from path_tracer_ai_tpu_torch.scene.camera import Camera


def _t(a, device, dtype=None):
    # np.array copies: views of JAX buffers are read-only
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def scene_from_numpy(triangles, materials, lights, device="cpu") -> SceneData:
    """triangles: the 10 arrays of a TrianglesSoA (v0 v1 v2 n0 n1 n2 uv0
    uv1 uv2 mat_id); materials: (mtype, albedo, roughness, metallic, ior);
    lights: (position, color, intensity)."""
    return SceneData(
        triangles=triangles_from_numpy(*triangles, device=device),
        materials=MaterialTable(
            mtype=_t(materials[0], device, np.int32),
            albedo=_t(materials[1], device, np.float32),
            roughness=_t(materials[2], device, np.float32),
            metallic=_t(materials[3], device, np.float32),
            ior=_t(materials[4], device, np.float32),
        ),
        lights=Lights(*(_t(a, device, np.float32) for a in lights)),
    )


def accel_from_numpy(bmin, bmax, v0, e1, e2, tri_id, scene_min, scene_max,
                     sbmin, sbmax, cbmin, cbmax, device="cpu") -> ClusterAccel:
    f = lambda a: _t(a, device, np.float32)
    return ClusterAccel(
        bmin=f(bmin), bmax=f(bmax), v0=f(v0), e1=f(e1), e2=f(e2),
        tri_id=_t(tri_id, device, np.int32),
        scene_min=f(scene_min), scene_max=f(scene_max),
        sbmin=f(sbmin), sbmax=f(sbmax), cbmin=f(cbmin), cbmax=f(cbmax),
    )


def camera_from_numpy(position, forward, right, up, fov_deg,
                      device="cpu") -> Camera:
    f = lambda a: _t(a, device, np.float32)
    return Camera(position=f(position), forward=f(forward), right=f(right),
                  up=f(up), fov_deg=f(fov_deg))


def key_from_data(data, device="cpu") -> torch.Tensor:
    """uint32[2] key data (jax.random.key_data) -> the port's int64 key."""
    return torch.as_tensor(np.asarray(data, np.uint32).astype(np.int64),
                           device=device)
