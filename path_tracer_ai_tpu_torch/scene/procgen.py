"""Procedural benchmark/demo geometry.

The reference's default asset (IronMan/IronMan.obj, main.cpp:22) is not
shipped (gitignored upstream). For benchmarks and demos we generate a
deterministic stand-in of comparable triangle count: a subdivided icosphere
with displacement ("blob"), which produces the same kind of dense curved
triangle soup a character scan does.
"""

from __future__ import annotations

import os

import numpy as np

_PHI = (1.0 + np.sqrt(5.0)) / 2.0


def icosahedron():
    v = np.asarray(
        [
            [-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
            [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
            [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    return v, f


def icosphere(subdivisions: int):
    """Subdivided unit icosphere: 20 * 4^n triangles (vectorized build)."""
    v, f = icosahedron()
    for _ in range(subdivisions):
        n_f = f.shape[0]
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges_key = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges_key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_idx = v.shape[0] + np.arange(uniq.shape[0])
        v = np.concatenate([v, mid])
        ab = mid_idx[inv[:n_f]]
        bc = mid_idx[inv[n_f:2 * n_f]]
        ca = mid_idx[inv[2 * n_f:]]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([
            np.stack([a, ab, ca], 1),
            np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1),
            np.stack([ab, bc, ca], 1),
        ])
    return v, f


def blob_mesh(subdivisions: int = 5, seed: int = 7, bumps: int = 24):
    """Displaced icosphere (deterministic): vertices, faces, vertex normals.

    Displacement is a sum of Gaussian bumps, so normals stay well-defined and
    the surface is curved + locally varied like a scanned model.
    """
    v, f = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((bumps, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amps = rng.uniform(0.03, 0.18, bumps)
    widths = rng.uniform(0.15, 0.5, bumps)

    r = np.ones(v.shape[0])
    for c, a, wdt in zip(centers, amps, widths):
        d2 = np.sum((v - c) ** 2, axis=1)
        r += a * np.exp(-d2 / (2 * wdt * wdt))
    pts = v * r[:, None]

    # Area-weighted vertex normals.
    e1 = pts[f[:, 1]] - pts[f[:, 0]]
    e2 = pts[f[:, 2]] - pts[f[:, 0]]
    fn = np.cross(e1, e2)
    vn = np.zeros_like(pts)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)
    return pts.astype(np.float32), f.astype(np.int32), vn.astype(np.float32)


def write_obj(path: str, subdivisions: int = 5, seed: int = 7) -> str:
    """Write the blob as OBJ+MTL (one material, `gold_blob`, with Ni 1.45)
    and return the OBJ path: the reference's procgen.write_obj, byte for
    byte (the benchmark configurations' scene)."""
    pts, faces, vn = blob_mesh(subdivisions, seed)
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as fh:
        fh.write("newmtl gold_blob\nKd 0.8 0.65 0.15\nNi 1.45\n")
    with open(path, "w") as fh:
        fh.write(f"mtllib {os.path.basename(mtl_path)}\n")
        for p in pts:
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for n in vn:
            fh.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        fh.write("usemtl gold_blob\n")
        for a, b, c in faces + 1:
            fh.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
    return path


BLOB_MTL = """newmtl gold_body
Kd 0.8 0.6 0.1
newmtl blob_plain
Kd 0.3 0.5 0.7
"""


def write_blob_obj(obj_path: str, subdivisions: int = 6, seed: int = 7) -> int:
    """Write the blob as an OBJ with `vn` normals and an MTL beside it (same
    stem): faces of the first half on `gold_body` (a name override), the
    rest on `blob_plain` (a plain Kd). The stand-in for a user's model, read
    back with scene.build_scene. Returns the face count."""
    pts, faces, vn = blob_mesh(subdivisions=subdivisions, seed=seed)
    mtl_name = os.path.splitext(os.path.basename(obj_path))[0] + ".mtl"
    with open(os.path.join(os.path.dirname(obj_path), mtl_name), "w") as fh:
        fh.write(BLOB_MTL)
    fmt = lambda tag, a: "".join(
        f"{tag} {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in a.tolist())
    f1 = faces + 1
    corner = lambda lo, hi: "".join(
        f"f {a}//{a} {b}//{b} {c}//{c}\n" for a, b, c in f1[lo:hi].tolist())
    half = faces.shape[0] // 2
    with open(obj_path, "w") as fh:
        fh.write(f"mtllib {mtl_name}\n")
        fh.write(fmt("v", pts))
        fh.write(fmt("vn", vn))
        fh.write("usemtl gold_body\n" + corner(0, half))
        fh.write("usemtl blob_plain\n" + corner(half, faces.shape[0]))
    return faces.shape[0]
