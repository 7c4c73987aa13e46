"""Scene assembly from arrays (counterpart of scene/scene.py, array part).

Keeps the reference's hardcoded data as tables: the 8 procedural room
triangles (scene.cpp:118-209), the 4 point lights (scene.hpp:55-80) and
the two default materials (scene.cpp:57-71). The OBJ loader path
(`build_scene`) is not part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from path_tracer_ai_tpu_torch.core.types import (
    MATERIAL_DIFFUSE,
    MATERIAL_SPECULAR,
    Lights,
    MaterialTable,
    SceneData,
    f32,
    i32,
    triangles_from_numpy,
)

ROOM_SIZE = 8.0           # scene.cpp:119
ROOM_HEIGHT = 4.0         # scene.cpp:120
WALL_MAT_ID = 1           # scene.cpp:121

# The four hardcoded point lights: position, color, intensity.
DEFAULT_LIGHTS = [
    ((2.0, 3.5, 2.0), (1.0, 0.95, 0.8), 9.0),   # key
    ((-1.5, 2.0, 1.5), (0.8, 0.9, 1.0), 2.0),   # fill
    ((0.0, 2.0, -2.0), (1.0, 1.0, 1.0), 1.0),   # rim
    ((0.0, 0.1, 0.0), (0.9, 0.9, 1.0), 2.0),    # ground bounce
]

# The 8 room triangles, wall material id 1: (v0, v1, v2, normal, uv0..2).
_S, _H = ROOM_SIZE, ROOM_HEIGHT
ROOM_TRIANGLES = [
    # Floor
    ((-_S, 0, -_S), (_S, 0, -_S), (_S, 0, _S), (0, 1, 0), (0, 0), (1, 0), (1, 1)),
    ((-_S, 0, -_S), (_S, 0, _S), (-_S, 0, _S), (0, 1, 0), (0, 0), (1, 1), (0, 1)),
    # Back wall
    ((-_S, 0, -_S), (-_S, _H, -_S), (_S, _H, -_S), (0, 0, 1), (0, 0), (0, 1), (1, 1)),
    ((-_S, 0, -_S), (_S, _H, -_S), (_S, 0, -_S), (0, 0, 1), (0, 0), (1, 1), (1, 0)),
    # Left wall
    ((-_S, 0, -_S), (-_S, 0, _S), (-_S, _H, _S), (1, 0, 0), (0, 0), (1, 0), (1, 1)),
    ((-_S, 0, -_S), (-_S, _H, _S), (-_S, _H, -_S), (1, 0, 0), (0, 0), (1, 1), (0, 1)),
    # Right wall
    ((_S, 0, -_S), (_S, _H, _S), (_S, 0, _S), (-1, 0, 0), (0, 0), (1, 1), (1, 0)),
    ((_S, 0, -_S), (_S, _H, -_S), (_S, _H, _S), (-1, 0, 0), (0, 0), (0, 1), (1, 1)),
]


@dataclasses.dataclass
class HostMaterial:
    """Host-side material record (defaults mirror material.hpp:12-18)."""

    mtype: int = MATERIAL_DIFFUSE
    albedo: tuple = (0.8, 0.8, 0.8)
    roughness: float = 0.5
    metallic: float = 0.5
    ior: float = 1.5


def _default_model_material() -> HostMaterial:
    """Material [0]: metallic red default (scene.cpp:57-63)."""
    return HostMaterial(
        mtype=MATERIAL_SPECULAR, albedo=(0.9, 0.2, 0.2), roughness=0.1, metallic=1.0
    )


def _wall_material() -> HostMaterial:
    """Material [1]: diffuse wall (scene.cpp:65-71)."""
    return HostMaterial(
        mtype=MATERIAL_DIFFUSE, albedo=(0.9, 0.9, 0.9), roughness=0.95, metallic=0.0
    )


def _room_triangle_arrays():
    """The 8 room triangles as numpy SoA blocks (10 arrays)."""
    n = len(ROOM_TRIANGLES)
    v0 = np.zeros((n, 3), np.float32)
    v1 = np.zeros((n, 3), np.float32)
    v2 = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    uv0 = np.zeros((n, 2), np.float32)
    uv1 = np.zeros((n, 2), np.float32)
    uv2 = np.zeros((n, 2), np.float32)
    for i, (a, b, c, nn, ua, ub, uc) in enumerate(ROOM_TRIANGLES):
        v0[i], v1[i], v2[i], nrm[i] = a, b, c, nn
        uv0[i], uv1[i], uv2[i] = ua, ub, uc
    mat = np.full((n,), WALL_MAT_ID, np.int32)
    return v0, v1, v2, nrm, nrm.copy(), nrm.copy(), uv0, uv1, uv2, mat


def pack_materials(mats: List[HostMaterial], device="cpu") -> MaterialTable:
    return MaterialTable(
        mtype=i32([m.mtype for m in mats], device),
        albedo=f32([m.albedo for m in mats], device),
        roughness=f32([m.roughness for m in mats], device),
        metallic=f32([m.metallic for m in mats], device),
        ior=f32([m.ior for m in mats], device),
    )


def default_lights(device="cpu") -> Lights:
    return Lights(
        position=f32([l[0] for l in DEFAULT_LIGHTS], device),
        color=f32([l[1] for l in DEFAULT_LIGHTS], device),
        intensity=f32([l[2] for l in DEFAULT_LIGHTS], device),
    )


def build_scene_from_arrays(
    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id,
    materials: Optional[List[HostMaterial]] = None,
    lights: Optional[Lights] = None,
    device="cpu",
) -> SceneData:
    """Assemble a SceneData on `device` from raw triangle arrays."""
    if materials is None:
        materials = [_default_model_material(), _wall_material()]
    return SceneData(
        triangles=triangles_from_numpy(
            v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, device=device
        ),
        materials=pack_materials(materials, device),
        lights=lights if lights is not None else default_lights(device),
    )


def scene_to(scene: SceneData, device) -> SceneData:
    """The same scene with every tensor on `device`."""
    return SceneData(*(
        type(part)(*(t.to(device) for t in part)) for part in scene
    ))


def blob_room_arrays(subdivisions: int, seed: int = 7):
    """Room + displaced blob (scaled 1.2, lifted 1.8) as 10 numpy arrays,
    with the blob on material 2 — the scene the benchmark renders."""
    from path_tracer_ai_tpu_torch.scene.procgen import blob_mesh

    pts, faces, vn = blob_mesh(subdivisions=subdivisions, seed=seed)
    pts = pts * 1.2 + np.asarray([0.0, 1.8, 0.0], np.float32)
    v = pts[faces]
    n = vn[faces]
    uv = np.zeros((faces.shape[0], 3, 2), np.float32)
    blob = (
        v[:, 0], v[:, 1], v[:, 2], n[:, 0], n[:, 1], n[:, 2],
        uv[:, 0], uv[:, 1], uv[:, 2], np.full(faces.shape[0], 2, np.int32),
    )
    room = _room_triangle_arrays()
    return [np.concatenate([room[i], blob[i]]) for i in range(10)]


def blob_materials() -> List[HostMaterial]:
    """Default red, diffuse wall, and the gold blob body (id 2)."""
    return [
        _default_model_material(),
        _wall_material(),
        HostMaterial(mtype=MATERIAL_SPECULAR, albedo=(1.0, 0.8, 0.0),
                     roughness=0.05, metallic=1.0),
    ]


def blob_scene(subdivisions: int = 6, device=None) -> SceneData:
    """The benchmark scene: room, 4 lights, gold blob of 20*4^n triangles."""
    from path_tracer_ai_tpu_torch.device import resolve_device

    return build_scene_from_arrays(
        *blob_room_arrays(subdivisions), materials=blob_materials(),
        device=resolve_device(device),
    )
