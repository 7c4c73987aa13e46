"""Triangle-cluster acceleration structure (counterpart of accel/clusters.py).

Triangles are ordered by a recursive median split (cluster-size aligned)
and packed into C clusters of S slots; padding slots are all-zero
triangles (determinant 0, never hit) with tri_id -1. Each cluster gets an
AABB, and groups of `super_size` consecutive clusters a supercluster AABB.
The build runs on the host (numpy, or the native C++ split order); the
result is a NamedTuple of tensors on the requested device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ClusterAccel(NamedTuple):
    bmin: torch.Tensor       # [C, 3] cluster AABB min
    bmax: torch.Tensor       # [C, 3] cluster AABB max
    v0: torch.Tensor         # [C, S, 3] triangle base vertex
    e1: torch.Tensor         # [C, S, 3] edge v1-v0
    e2: torch.Tensor         # [C, S, 3] edge v2-v0
    tri_id: torch.Tensor     # [C, S] int32 global triangle index (-1 = padding)
    scene_min: torch.Tensor  # [3]
    scene_max: torch.Tensor  # [3]
    sbmin: torch.Tensor      # [Cs, 3] supercluster AABB min
    sbmax: torch.Tensor      # [Cs, 3]
    cbmin: torch.Tensor      # [Cs, super_size, 3] child AABBs (inverted padding)
    cbmax: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.bmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.v0.shape[1]

    @property
    def num_supers(self) -> int:
        return self.sbmin.shape[0]

    @property
    def super_size(self) -> int:
        return self.cbmin.shape[1]

    def to(self, device) -> "ClusterAccel":
        return ClusterAccel(*(t.to(device) for t in self))


def _median_split_order(centers: np.ndarray, cluster_size: int) -> np.ndarray:
    """Recursive median split on the longest axis, cluster-size aligned
    (the reference BVH's strategy, bvh.hpp:44-72, stopped at S leaves)."""
    s = cluster_size
    out = []
    stack = [np.arange(centers.shape[0], dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if idx.size <= s:
            out.append(idx)
            continue
        c = centers[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        half = ((idx.size // 2 + s - 1) // s) * s
        half = min(max(half, s), idx.size - 1)
        part = np.argpartition(c[:, axis], half - 1)
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    return np.concatenate(out)


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def build_clusters(tris, cluster_size: int = 128, super_size: int = 16,
                   device=None) -> ClusterAccel:
    """Split-order the triangles and pack them into fixed-size clusters.

    tris: anything with v0/v1/v2 ([T,3] arrays or tensors). The result
    lives on `device` (default: the device of tris.v0, or the CPU for
    numpy input)."""
    from path_tracer_ai_tpu_torch.accel.native import native_split_order

    if device is None:
        device = tris.v0.device if torch.is_tensor(tris.v0) else "cpu"
    v0, v1, v2 = _host(tris.v0), _host(tris.v1), _host(tris.v2)
    t = v0.shape[0]
    if t == 0:
        raise ValueError("cannot build acceleration structure over 0 triangles")

    centers = (v0 + v1 + v2) / 3.0
    order = native_split_order(centers, cluster_size)
    if order is None:
        order = _median_split_order(centers, cluster_size)
    order = order.astype(np.int64)

    s = cluster_size
    c = -(-t // s)
    pad = c * s - t

    def pack(a, fill=0.0):
        a = a[order]
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a.reshape(c, s, *a.shape[1:])

    pv0, pv1, pv2 = pack(v0), pack(v1), pack(v2)
    tri_id = order.astype(np.int32)
    if pad:
        tri_id = np.concatenate([tri_id, np.full(pad, -1, np.int32)])
    tri_id = tri_id.reshape(c, s)

    # Padding triangles must not inflate the cluster AABBs.
    valid = (tri_id >= 0)[..., None]
    big = np.float32(np.finfo(np.float32).max)
    lo = np.where(valid, np.minimum(np.minimum(pv0, pv1), pv2), big)
    hi = np.where(valid, np.maximum(np.maximum(pv0, pv1), pv2), -big)
    bmin = lo.min(axis=1)
    bmax = hi.max(axis=1)

    scene_min = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    scene_max = np.maximum(np.maximum(v0, v1), v2).max(axis=0)

    # Supercluster level; child slots past C are inverted boxes.
    g = super_size
    cs = -(-c // g)
    big = np.float32(3.0e37)
    cbmin = np.full((cs * g, 3), big, np.float32)
    cbmax = np.full((cs * g, 3), -big, np.float32)
    cbmin[:c] = bmin
    cbmax[:c] = bmax
    cbmin = cbmin.reshape(cs, g, 3)
    cbmax = cbmax.reshape(cs, g, 3)

    t_ = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return ClusterAccel(
        bmin=t_(bmin), bmax=t_(bmax),
        v0=t_(pv0), e1=t_(pv1 - pv0), e2=t_(pv2 - pv0),
        tri_id=t_(tri_id),
        scene_min=t_(scene_min.astype(np.float32)),
        scene_max=t_(scene_max.astype(np.float32)),
        sbmin=t_(cbmin.min(axis=1)), sbmax=t_(cbmax.max(axis=1)),
        cbmin=t_(cbmin), cbmax=t_(cbmax),
    )
