"""Cornell-style test scene (counterpart of scene/cornell.py).

The reference has no such scene; it is a golden scene for global
illumination: coloured diffuse walls, so indirect bounces pick up colour
bleeding, and one point light near the ceiling (the reference's light
model: no emissive geometry, renderer.hpp:252-301).
"""

from __future__ import annotations

from path_tracer_ai_tpu_torch.core.types import (
    MATERIAL_DIFFUSE,
    Lights,
    SceneData,
    f32,
)
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.scene.camera import Camera, make_camera
from path_tracer_ai_tpu_torch.scene.scene import (
    HostMaterial,
    build_scene_from_arrays,
)

WHITE, RED, GREEN = 0, 1, 2


def _quad(a, b, c, d, n, mat):
    """Two triangles for quad a-b-c-d with shared normal."""
    return [(a, b, c, n, mat), (a, c, d, n, mat)]


def _box(center, size, mat):
    """Axis-aligned box as 12 triangles with outward normals."""
    cx, cy, cz = center
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    x0, x1, y0, y1, z0, z1 = cx - sx, cx + sx, cy - sy, cy + sy, cz - sz, cz + sz
    tris = []
    tris += _quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (0, 0, 1), mat)
    tris += _quad((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (0, 0, -1), mat)
    tris += _quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (-1, 0, 0), mat)
    tris += _quad((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (1, 0, 0), mat)
    tris += _quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), (0, 1, 0), mat)
    tris += _quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), (0, -1, 0), mat)
    return tris


def build_cornell_scene(device=None) -> tuple[SceneData, Camera]:
    """2-unit Cornell box at the origin, camera on +z looking in, on
    `device` (None: the card)."""
    device = resolve_device(device)
    s = 1.0  # half-extent
    tris = []
    # floor, ceiling, back (white)
    tris += _quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), (0, 1, 0), WHITE)
    tris += _quad((-s, 2 * s, s), (s, 2 * s, s), (s, 2 * s, -s), (-s, 2 * s, -s), (0, -1, 0), WHITE)
    tris += _quad((-s, 0, -s), (-s, 2 * s, -s), (s, 2 * s, -s), (s, 0, -s), (0, 0, 1), WHITE)
    # left wall red, right wall green
    tris += _quad((-s, 0, -s), (-s, 0, s), (-s, 2 * s, s), (-s, 2 * s, -s), (1, 0, 0), RED)
    tris += _quad((s, 0, s), (s, 0, -s), (s, 2 * s, -s), (s, 2 * s, s), (-1, 0, 0), GREEN)
    # two white boxes
    tris += _box((-0.35, 0.6, -0.35), (0.55, 1.2, 0.55), WHITE)  # tall
    tris += _box((0.4, 0.25, 0.35), (0.5, 0.5, 0.5), WHITE)      # short

    mats = [
        HostMaterial(mtype=MATERIAL_DIFFUSE, albedo=(0.73, 0.73, 0.73), roughness=0.9, metallic=0.0),
        HostMaterial(mtype=MATERIAL_DIFFUSE, albedo=(0.65, 0.05, 0.05), roughness=0.9, metallic=0.0),
        HostMaterial(mtype=MATERIAL_DIFFUSE, albedo=(0.12, 0.45, 0.15), roughness=0.9, metallic=0.0),
    ]
    lights = Lights(
        position=f32([[0.0, 1.9, 0.0]], device),
        color=f32([[1.0, 1.0, 1.0]], device),
        intensity=f32([3.0], device),
    )

    col = lambda i: [t[i] for t in tris]
    n = col(3)
    uv = [[0.0, 0.0]] * len(tris)
    scene = build_scene_from_arrays(
        col(0), col(1), col(2), n, n, n, uv, uv, uv, col(4),
        materials=mats, lights=lights, device=device,
    )
    camera = make_camera(
        position=(0.0, 1.0, 3.4), target=(0.0, 1.0, 0.0), up=(0, 1, 0),
        fov_deg=40.0, device=device,
    )
    return scene, camera
