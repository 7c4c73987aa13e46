"""Minimal OBJ/MTL parser (numpy, host-side; counterpart of
scene/objloader.py).

Replaces the reference's vendored tinyobjloader (used at src/scene.cpp:11-28)
with the subset of OBJ/MTL this renderer needs:

- v / vn / vt records
- f records with v, v/vt, v//vn, v/vt/vn forms, negative (relative) indices,
  and fan triangulation of polygons (tinyobjloader's `triangulate = true`
  equivalent for the convex faces found in practice; scene.cpp:13)
- mtllib / usemtl with per-face material indices in MTL-file order
  (faces with no usemtl get material id -1, matching tinyobj)
- MTL: newmtl, Kd, Ni, d, illum (the fields scene.build_scene consumes)

The native C++ parser (accel.native.native_load_obj) is the fast path and
this module's Python parser the fallback; both give the same arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class ObjMaterial:
    name: str
    # tinyobjloader's default diffuse is (0.6, 0.6, 0.6) when Kd is absent.
    diffuse: tuple = (0.6, 0.6, 0.6)
    ior: float = 1.5        # Ni; reference Material default ior (material.hpp:17)
    dissolve: float = 1.0   # d
    illum: int = 2


@dataclasses.dataclass
class ObjData:
    """Parsed, triangulated OBJ content.

    vertices:  [Nv, 3] float32 raw positions (pre-transform)
    normals:   [Nn, 3] float32
    texcoords: [Nt, 2] float32
    v_idx:     [F, 3] int32 vertex indices per triangle
    n_idx:     [F, 3] int32 normal indices (-1 where absent)
    t_idx:     [F, 3] int32 texcoord indices (-1 where absent)
    mat_ids:   [F] int32 per-triangle material index into `materials` (-1 none)
    materials: MTL materials in file order
    parser:    which parser read the file, "native" or "python"
    """

    vertices: np.ndarray
    normals: np.ndarray
    texcoords: np.ndarray
    v_idx: np.ndarray
    n_idx: np.ndarray
    t_idx: np.ndarray
    mat_ids: np.ndarray
    materials: List[ObjMaterial]
    parser: str = "python"


def _parse_floats(parts, n):
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return vals


def parse_mtl(path: str) -> List[ObjMaterial]:
    materials: List[ObjMaterial] = []
    cur: ObjMaterial | None = None
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = ObjMaterial(name=parts[1] if len(parts) > 1 else "")
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.diffuse = tuple(_parse_floats(parts[1:], 3))
            elif key == "Ni":
                cur.ior = float(parts[1])
            elif key == "d":
                cur.dissolve = float(parts[1])
            elif key == "Tr":  # inverted dissolve convention
                cur.dissolve = 1.0 - float(parts[1])
            elif key == "illum":
                cur.illum = int(float(parts[1]))
    return materials


def _resolve_index(raw: str, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based (or -1 if empty)."""
    if raw == "":
        return -1
    i = int(raw)
    return i - 1 if i > 0 else count + i


def _triangulate_face(corners, vertices):
    """Corner-index triples triangulating one face (ear clipping).

    The role of tinyobjloader's `triangulate=true` (reference
    src/scene.cpp:13): CONVEX faces keep the fan from corner 0, concave
    faces are ear-clipped so no triangle falls outside the polygon. The
    native C++ parser (native/ptnative.cpp triangulate_face) runs the same
    algorithm in the same double-precision order, so both paths give the
    same triangles.
    """
    n = len(corners)
    if n <= 3:
        return [(0, 1, 2)] if n == 3 else []

    def pos(k):
        vi = corners[k][0]
        if vi < 0 or vi >= len(vertices):
            return None
        return vertices[vi]

    pts = [pos(k) for k in range(n)]
    if any(p is None for p in pts):
        return [(0, k, k + 1) for k in range(1, n - 1)]

    # Newell normal (double precision, matching the C++ implementation).
    nx = ny = nz = 0.0
    for i in range(n):
        j = (i + 1) % n
        xi, yi, zi = (float(c) for c in pts[i])
        xj, yj, zj = (float(c) for c in pts[j])
        nx += (yi - yj) * (zi + zj)
        ny += (zi - zj) * (xi + xj)
        nz += (xi - xj) * (yi + yj)
    ax, ay, az = abs(nx), abs(ny), abs(nz)
    if ax >= ay and ax >= az:
        axis, sgn = 0, (1.0 if nx >= 0.0 else -1.0)
        uv = [(float(p[1]), float(p[2])) for p in pts]
    elif ay >= az:
        axis, sgn = 1, (1.0 if ny >= 0.0 else -1.0)
        uv = [(float(p[2]), float(p[0])) for p in pts]
    else:
        axis, sgn = 2, (1.0 if nz >= 0.0 else -1.0)
        uv = [(float(p[0]), float(p[1])) for p in pts]
    del axis
    if ax == 0.0 and ay == 0.0 and az == 0.0:
        return [(0, k, k + 1) for k in range(1, n - 1)]

    scale = 0.0
    for u, v in uv:
        scale = max(scale, abs(u), abs(v))
    eps = 1e-12 * scale * scale

    def cross2(a, b, c):
        return ((uv[b][0] - uv[a][0]) * (uv[c][1] - uv[b][1])
                - (uv[b][1] - uv[a][1]) * (uv[c][0] - uv[b][0]))

    convex = True
    for i in range(n):
        if sgn * cross2(i, (i + 1) % n, (i + 2) % n) < -eps:
            convex = False
            break
    if convex:
        return [(0, k, k + 1) for k in range(1, n - 1)]

    def inside(m, a, b, c):
        return (sgn * cross2(a, b, m) > eps
                and sgn * cross2(b, c, m) > eps
                and sgn * cross2(c, a, m) > eps)

    live = list(range(n))
    out = []
    while len(live) > 3:
        clipped = False
        for idx in range(len(live)):
            a = live[idx - 1] if idx else live[-1]
            b = live[idx]
            c = live[(idx + 1) % len(live)]
            if sgn * cross2(a, b, c) <= eps:
                continue  # reflex or flat corner: not an ear
            if any(m not in (a, b, c) and inside(m, a, b, c)
                   for m in live):
                continue
            out.append((a, b, c))
            live.pop(idx)
            clipped = True
            break
        if not clipped:
            # Degenerate remainder (self-intersecting/collinear input):
            # complete with a fan, like tinyobjloader's failure mode.
            out.extend((live[0], live[k], live[k + 1])
                       for k in range(1, len(live) - 1))
            return out
    out.append((live[0], live[1], live[2]))
    return out


def load_obj(path: str, prefer_native: bool = True) -> ObjData:
    """Parse an OBJ file (native C++ fast path, pure-Python fallback)."""
    if prefer_native:
        try:
            from path_tracer_ai_tpu_torch.accel.native import native_load_obj

            data = native_load_obj(path)
            if data is not None:
                return data
        except OSError:
            raise  # unreadable file: consistent error either path
        except Exception as e:  # noqa: BLE001 — the fast path never blocks a load
            log.warning("native OBJ parser failed (%s); using the Python one", e)
    return _load_obj_py(path)


def _load_obj_py(path: str) -> ObjData:
    vertices: list = []
    normals: list = []
    texcoords: list = []
    v_idx: list = []
    n_idx: list = []
    t_idx: list = []
    mat_ids: list = []
    materials: List[ObjMaterial] = []
    mat_lookup: dict = {}
    current_mat = -1
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                vertices.append(_parse_floats(parts[1:], 3))
            elif key == "vn":
                normals.append(_parse_floats(parts[1:], 3))
            elif key == "vt":
                texcoords.append(_parse_floats(parts[1:], 2))
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _resolve_index(comps[0], len(vertices))
                    ti = _resolve_index(comps[1], len(texcoords)) if len(comps) > 1 else -1
                    ni = _resolve_index(comps[2], len(normals)) if len(comps) > 2 else -1
                    corners.append((vi, ti, ni))
                # Triangulation (scene.cpp relies on tinyobj triangulate):
                # fan for convex faces, ear clipping for concave ones.
                for ia, ib, ic in _triangulate_face(corners, vertices):
                    tri = (corners[ia], corners[ib], corners[ic])
                    v_idx.append([c[0] for c in tri])
                    t_idx.append([c[1] for c in tri])
                    n_idx.append([c[2] for c in tri])
                    mat_ids.append(current_mat)
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                current_mat = mat_lookup.get(name, -1)
            elif key == "mtllib":
                # mtllib may list several files; paths relative to the OBJ.
                for mtl_name in parts[1:]:
                    mtl_path = os.path.join(base_dir, mtl_name)
                    if not os.path.exists(mtl_path):
                        continue
                    for m in parse_mtl(mtl_path):
                        mat_lookup[m.name] = len(materials)
                        materials.append(m)

    def arr(lst, dtype, width):
        if not lst:
            return np.zeros((0, width), dtype=dtype)
        return np.asarray(lst, dtype=dtype)

    return ObjData(
        vertices=arr(vertices, np.float32, 3),
        normals=arr(normals, np.float32, 3),
        texcoords=arr(texcoords, np.float32, 2),
        v_idx=arr(v_idx, np.int32, 3),
        n_idx=arr(n_idx, np.int32, 3),
        t_idx=arr(t_idx, np.int32, 3),
        mat_ids=np.asarray(mat_ids, dtype=np.int32) if mat_ids else np.zeros((0,), np.int32),
        materials=materials,
    )
