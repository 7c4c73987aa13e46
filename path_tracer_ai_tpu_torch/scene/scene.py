"""Scene assembly (counterpart of scene/scene.py; Scene +
Scene::loadFromObj, scene.hpp/scene.cpp).

Keeps the reference's hardcoded data as tables: the 8 procedural room
triangles (scene.cpp:118-209), the 4 point lights (scene.hpp:55-80) and
the two default materials (scene.cpp:57-71). `build_scene` loads an
OBJ+MTL model with every loader invariant of the reference:
- model bounds over ALL file vertices, uniform scale to a 3-unit box
  (scene.cpp:48-49), recenter, z-flip (180 degrees about Y), y += 1.8
  (scene.cpp:236-238);
- normals z-flipped and normalized, the face normal where the last corner
  has none (scene.cpp:243-256); uv (0, 0) where absent (scene.cpp:258-265);
- MTL materials appended at +2 (scene.cpp:57-71, 268-270), with the
  name-keyed overrides red/gold/silver/black, else Kd^0.8 * 1.2 clamped,
  all SPECULAR metallic 1 (scene.cpp:74-108);
- the 8 room triangles PREPENDED before the model (scene.cpp:118-209).
An extension, off by default: with `enable_dielectrics=True`, MTL
materials named *glass* / *dielectric*, or with illum 7 or dissolve < 1,
become MATERIAL_DIELECTRIC with the MTL's Ni.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from path_tracer_ai_tpu_torch.core.types import (
    MATERIAL_DIELECTRIC,
    MATERIAL_DIFFUSE,
    MATERIAL_SPECULAR,
    Lights,
    MaterialTable,
    SceneData,
    f32,
    i32,
    triangles_from_numpy,
)
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.scene.objloader import ObjMaterial, load_obj
from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MODEL_TARGET_SIZE = 3.0   # scene.cpp:48 (comment says 1.5, code says 3)
MODEL_LIFT_Y = 1.8        # scene.cpp:238
ROOM_SIZE = 8.0           # scene.cpp:119
ROOM_HEIGHT = 4.0         # scene.cpp:120
WALL_MAT_ID = 1           # scene.cpp:121
MTL_MATERIAL_OFFSET = 2   # scene.cpp:270

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


def _convert_mtl_material(m: ObjMaterial, enable_dielectrics: bool) -> HostMaterial:
    """Name-keyed overrides (scene.cpp:74-108) + optional dielectric extension."""
    out = HostMaterial(mtype=MATERIAL_SPECULAR, metallic=1.0, roughness=0.1)
    name = m.name
    if "red" in name:
        out.albedo, out.roughness = (0.9, 0.2, 0.2), 0.1
    elif "gold" in name:
        out.albedo, out.roughness = (1.0, 0.8, 0.0), 0.05
    elif "silver" in name:  # covers "darksilver" too (scene.cpp:89-90)
        out.albedo, out.roughness = (0.95, 0.95, 0.95), 0.05
    elif "black" in name:
        out.albedo, out.roughness = (0.02, 0.02, 0.02), 0.1
    else:
        kd = np.asarray(m.diffuse, dtype=np.float32)
        kd = np.power(np.maximum(kd, 0.0), 0.8)       # vibrance (scene.cpp:104)
        kd = np.clip(kd * 1.2, 0.0, 1.0)              # brighten (scene.cpp:105)
        out.albedo = tuple(float(x) for x in kd)

    if enable_dielectrics and (
        "glass" in name or "dielectric" in name or m.illum == 7 or m.dissolve < 1.0
    ):
        out.mtype = MATERIAL_DIELECTRIC
        out.ior = float(m.ior) if m.ior > 0 else 1.5
    return out


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


def transform_model_vertices(raw: np.ndarray, center: np.ndarray, scale: float):
    """The reference vertex transform chain (scene.cpp:236-238)."""
    v = (raw - center) * scale
    v = v * np.asarray([1.0, 1.0, -1.0], np.float32)  # 180 degrees about Y
    v = v + np.asarray([0.0, MODEL_LIFT_Y, 0.0], np.float32)
    return v.astype(np.float32)


def pack_materials(mats: List[HostMaterial], device=None) -> MaterialTable:
    device = resolve_device(device)
    return MaterialTable(
        mtype=i32([m.mtype for m in mats], device),
        albedo=f32([m.albedo for m in mats], device),
        roughness=f32([m.roughness for m in mats], device),
        metallic=f32([m.metallic for m in mats], device),
        ior=f32([m.ior for m in mats], device),
    )


def default_lights(device=None) -> Lights:
    device = resolve_device(device)
    return Lights(
        position=f32([l[0] for l in DEFAULT_LIGHTS], device),
        color=f32([l[1] for l in DEFAULT_LIGHTS], device),
        intensity=f32([l[2] for l in DEFAULT_LIGHTS], device),
    )


def build_scene_from_arrays(
    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id,
    materials: Optional[List[HostMaterial]] = None,
    lights: Optional[Lights] = None,
    device=None,
) -> SceneData:
    """Assemble a SceneData on `device` (None: the card) from raw triangle
    arrays."""
    device = resolve_device(device)
    if materials is None:
        materials = [_default_model_material(), _wall_material()]
    return SceneData(
        triangles=triangles_from_numpy(
            v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, device=device
        ),
        materials=pack_materials(materials, device),
        lights=lights if lights is not None else default_lights(device),
    )


def build_scene(obj_path: str, enable_dielectrics: bool = False,
                include_room: bool = True, lights: Optional[Lights] = None,
                device=None) -> SceneData:
    """Load an OBJ+MTL model into the reference's walled-room scene on
    `device` (None: the card).

    Mirrors Scene::loadFromObj (scene.cpp:8-293) end to end. Raises OSError
    on a missing or unreadable file (the loader's `return false`, which
    main() turns into an error exit, main.cpp:40-43) and ValueError when
    the scene has no triangle.
    """
    device = resolve_device(device)
    log.info("Loading model from: %s", obj_path)
    obj = load_obj(obj_path)
    log.info("Parsed %s with the %s parser", obj_path, obj.parser)

    # Bounds over ALL file vertices, referenced or not (scene.cpp:30-42).
    if obj.vertices.shape[0] > 0:
        min_b = obj.vertices.min(axis=0)
        max_b = obj.vertices.max(axis=0)
        model_size = max_b - min_b
        log.info("Original model size: %s", model_size.tolist())
        max_extent = float(model_size.max())
        scale = MODEL_TARGET_SIZE / max_extent if max_extent > 0 else 1.0
        center = ((min_b + max_b) * 0.5).astype(np.float32)
    else:
        scale, center = 1.0, np.zeros(3, np.float32)

    # Material table (scene.cpp:54-114).
    materials: List[HostMaterial] = [_default_model_material(), _wall_material()]
    for m in obj.materials:
        hm = _convert_mtl_material(m, enable_dielectrics)
        materials.append(hm)
        log.info(
            "Loaded material: %s (type=%d, roughness=%g, metallic=%g)",
            m.name, hm.mtype, hm.roughness, hm.metallic,
        )

    blocks = []
    if include_room:
        blocks.append(_room_triangle_arrays())

    # Model triangles (scene.cpp:215-282), vectorized over faces.
    F = obj.v_idx.shape[0]
    if F > 0:
        verts = transform_model_vertices(obj.vertices, center, scale)  # [Nv,3]
        tri_v = verts[obj.v_idx]  # [F,3,3]

        # Normals: z-flip + normalize where indexed (scene.cpp:243-250);
        # face-normal fallback from transformed verts otherwise (:251-256).
        flip = np.asarray([1.0, 1.0, -1.0], np.float32)
        has_n = obj.n_idx >= 0  # [F,3]
        n_safe = np.clip(obj.n_idx, 0, max(obj.normals.shape[0] - 1, 0))
        if obj.normals.shape[0] > 0:
            vn = obj.normals[n_safe] * flip
            norms = np.linalg.norm(vn, axis=-1, keepdims=True)
            vn = vn / np.maximum(norms, 1e-30)
        else:
            vn = np.zeros((F, 3, 3), np.float32)
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        fn = np.cross(e1, e2)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
        # Reference: if the LAST corner lacks a normal, all three corners get
        # the face normal (scene.cpp:251-256). A corner missing a normal while
        # corner 2 has one reads uninitialized memory in the reference; the
        # face normal is used for any missing corner.
        last_missing = ~has_n[:, 2]
        use_face = last_missing[:, None] | ~has_n
        tri_n = np.where(use_face[..., None], fn[:, None, :], vn).astype(np.float32)

        # UVs with (0,0) fallback (scene.cpp:258-265).
        has_t = obj.t_idx >= 0
        t_safe = np.clip(obj.t_idx, 0, max(obj.texcoords.shape[0] - 1, 0))
        if obj.texcoords.shape[0] > 0:
            tri_uv = np.where(has_t[..., None], obj.texcoords[t_safe], 0.0)
        else:
            tri_uv = np.zeros((F, 3, 2), np.float32)
        tri_uv = tri_uv.astype(np.float32)

        # Material ids: max(id, 0) + 2 (scene.cpp:268-270).
        mat = np.maximum(obj.mat_ids, 0) + MTL_MATERIAL_OFFSET

        blocks.append((
            tri_v[:, 0], tri_v[:, 1], tri_v[:, 2],
            tri_n[:, 0], tri_n[:, 1], tri_n[:, 2],
            tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2],
            mat.astype(np.int32),
        ))

    if not blocks:
        raise ValueError(f"Scene has no triangles (empty OBJ: {obj_path})")

    cat = [np.concatenate([b[i] for b in blocks], axis=0) for i in range(10)]
    scene = build_scene_from_arrays(*cat, materials=materials, lights=lights,
                                    device=device)
    log.info(
        "Model loaded successfully: %d triangles, %d materials",
        scene.triangles.count, scene.materials.count,
    )
    return scene


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
    return build_scene_from_arrays(
        *blob_room_arrays(subdivisions), materials=blob_materials(),
        device=device,
    )
