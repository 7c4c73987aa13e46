"""Reference-parity median-split BVH, host-side, as flat numpy arrays
(counterpart of accel/bvh.py; bvh.hpp:23-117).

Top-down median split on the merged bounds' largest axis by partial
selection, leaves of up to 8 triangles. The render paths use the cluster
accel (accel.clusters); this BVH is the reference's L2 layer kept for
parity, an independent host-side oracle for the accel's invariants (every
triangle in exactly one leaf, child bounds inside their parent's) and a
debugging tool. It runs on the host: vertices and rays may be numpy arrays
or tensors on any device (read through `.cpu().numpy()`).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

MAX_TRIANGLES_PER_LEAF = 8  # bvh.hpp:42


def _host(x, dtype) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class FlatBVH(NamedTuple):
    """Flat binary BVH.

    bounds_min/max: [M, 3] per-node AABBs
    left/right:     [M] child node indices (-1 for leaves)
    first/count:    [M] triangle range [first, first+count) for leaves
    order:          [T] triangle ids; leaves reference contiguous runs
    """

    bounds_min: np.ndarray
    bounds_max: np.ndarray
    left: np.ndarray
    right: np.ndarray
    first: np.ndarray
    count: np.ndarray
    order: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.bounds_min.shape[0]


def build_bvh(v0, v1, v2, leaf_size: int = MAX_TRIANGLES_PER_LEAF) -> FlatBVH:
    v0 = _host(v0, np.float32)
    v1 = _host(v1, np.float32)
    v2 = _host(v2, np.float32)
    t = v0.shape[0]
    centers = (v0 + v1 + v2) / 3.0  # triangle.hpp:69-71
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    order = np.arange(t, dtype=np.int64)
    nodes = []  # (bmin, bmax, left, right, first, count)

    def rec(start: int, end: int) -> int:
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_id = len(nodes)
        nodes.append([bmin, bmax, -1, -1, -1, 0])

        n = end - start
        if n <= leaf_size:
            nodes[node_id][4] = start
            nodes[node_id][5] = n
            return node_id

        # split on the merged bounds' largest axis (aabb.hpp:34-39) at the
        # median centroid (bvh.hpp:60-66; argpartition = nth_element)
        extent = bmax - bmin
        if extent[0] > extent[1] and extent[0] > extent[2]:
            axis = 0
        elif extent[1] > extent[2]:
            axis = 1
        else:
            axis = 2
        mid = n // 2
        part = np.argpartition(centers[idx, axis], mid)
        order[start:end] = idx[part]

        left = rec(start, start + mid)
        right = rec(start + mid, end)
        nodes[node_id][2] = left
        nodes[node_id][3] = right
        return node_id

    if t > 0:
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            rec(0, t)
        finally:
            sys.setrecursionlimit(old_limit)

    m = len(nodes)
    empty = np.zeros((0, 3), np.float32)
    return FlatBVH(
        bounds_min=np.stack([n[0] for n in nodes]) if m else empty,
        bounds_max=np.stack([n[1] for n in nodes]) if m else empty,
        left=np.asarray([n[2] for n in nodes], np.int64),
        right=np.asarray([n[3] for n in nodes], np.int64),
        first=np.asarray([n[4] for n in nodes], np.int64),
        count=np.asarray([n[5] for n in nodes], np.int64),
        order=order,
    )


def intersect_bvh(bvh: FlatBVH, v0, v1, v2, origin, direction,
                  t_min=1e-3, t_max=np.inf):
    """Host-side nearest-hit query of one ray -> (hit, t, triangle id),
    stack-based, for validation and debugging only.

    Semantics of BVH::intersectNode (bvh.hpp:74-116): slab-test prune with
    the shrinking tMax, exact Möller–Trumbore in leaves (in float64, as the
    reference's host code)."""
    v0 = _host(v0, np.float32)
    v1 = _host(v1, np.float32)
    v2 = _host(v2, np.float32)
    origin = _host(origin, np.float64)
    direction = _host(direction, np.float64)
    best_t = float(t_max)
    best_tri = -1
    if bvh.num_nodes == 0:
        return False, np.inf, -1
    stack = [0]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / direction  # IEEE inf slopes, like aabb.hpp:15
    while stack:
        ni = stack.pop()
        with np.errstate(invalid="ignore"):
            lo = (bvh.bounds_min[ni] - origin) * inv
            hi = (bvh.bounds_max[ni] - origin) * inv
        near = np.minimum(lo, hi)
        far = np.maximum(lo, hi)
        tn, tf = float(t_min), best_t
        for a in range(3):
            if near[a] > tn:
                tn = near[a]
            if far[a] < tf:
                tf = far[a]
        if tf <= tn:
            continue
        if bvh.left[ni] < 0:  # leaf
            for k in range(bvh.first[ni], bvh.first[ni] + bvh.count[ni]):
                ti = int(bvh.order[k])
                e1 = v1[ti] - v0[ti]
                e2 = v2[ti] - v0[ti]
                h = np.cross(direction, e2)
                a = float(np.dot(e1, h))
                if abs(a) < 1e-7:
                    continue
                f = 1.0 / a
                s = origin - v0[ti]
                u = f * float(np.dot(s, h))
                if u < 0 or u > 1:
                    continue
                q = np.cross(s, e1)
                vv = f * float(np.dot(direction, q))
                if vv < 0 or u + vv > 1:
                    continue
                tt = f * float(np.dot(e2, q))
                if t_min <= tt <= best_t and tt < best_t:
                    best_t = tt
                    best_tri = ti
        else:
            stack.append(int(bvh.right[ni]))
            stack.append(int(bvh.left[ni]))
    return best_tri >= 0, best_t, best_tri
