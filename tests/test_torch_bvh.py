"""The port's host-side BVH (accel/bvh.py) against the JAX package's: the
same flat arrays from the same triangles, the invariants of
tests/test_bvh.py, and the same nearest hit on every ray. Both are numpy
code on the host; the port also takes tensors."""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import bvh as jbvh
from path_tracer_ai_tpu_torch.accel import bvh


@pytest.fixture
def soup(rng):
    t = 333
    base = rng.uniform(-5, 5, (t, 3)).astype(np.float32)
    v1 = base + rng.uniform(-0.8, 0.8, (t, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.8, 0.8, (t, 3)).astype(np.float32)
    return base, v1, v2


@pytest.mark.parametrize("leaf_size", [8, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_build_bvh_arrays_equal_jax(soup, leaf_size, as_tensor):
    ref = jbvh.build_bvh(*soup, leaf_size=leaf_size)
    args = [torch.as_tensor(v) for v in soup] if as_tensor else soup
    got = bvh.build_bvh(*args, leaf_size=leaf_size)
    for name in bvh.FlatBVH._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_bvh_of_nothing():
    got = bvh.build_bvh(*(np.zeros((0, 3), np.float32),) * 3)
    assert got.num_nodes == 0 and got.order.shape == (0,)
    assert bvh.intersect_bvh(got, *(np.zeros((0, 3)),) * 3, np.zeros(3),
                             np.ones(3)) == (False, np.inf, -1)


def test_invariants(soup):
    """Every triangle in exactly one leaf of 1..8, child bounds inside the
    parent's, each leaf's bounds around its triangles."""
    v0, v1, v2 = soup
    b = bvh.build_bvh(v0, v1, v2)
    seen = []
    for ni in range(b.num_nodes):
        if b.left[ni] < 0:
            ids = b.order[b.first[ni]: b.first[ni] + b.count[ni]]
            assert 1 <= ids.size <= bvh.MAX_TRIANGLES_PER_LEAF
            seen.extend(ids.tolist())
            pts = np.concatenate([v0[ids], v1[ids], v2[ids]])
            assert (pts >= b.bounds_min[ni] - 1e-5).all()
            assert (pts <= b.bounds_max[ni] + 1e-5).all()
        for ci in (b.left[ni], b.right[ni]):
            if ci >= 0:
                assert (b.bounds_min[ci] >= b.bounds_min[ni] - 1e-5).all()
                assert (b.bounds_max[ci] <= b.bounds_max[ni] + 1e-5).all()
    assert sorted(seen) == list(range(v0.shape[0]))


def test_intersect_bvh_equals_jax(soup, rng):
    """(hit, t, triangle) of JAX's query on every ray, axis-parallel rays
    and a finite t_max included; some rays hit."""
    b = bvh.build_bvh(*soup)
    ref_b = jbvh.build_bvh(*soup)
    hits = 0
    for i in range(40):
        o = rng.uniform(-7, 7, 3)
        d = rng.standard_normal(3)
        if i % 4 == 1:  # at a triangle's centroid
            j = rng.integers(0, soup[0].shape[0])
            d = (soup[0][j] + soup[1][j] + soup[2][j]) / 3.0 - o
        if i % 8 == 0:
            d[:2] = 0.0
        d /= np.linalg.norm(d)
        t_max = np.inf if i % 2 else 6.0
        ref = jbvh.intersect_bvh(ref_b, *soup, o, d, t_max=t_max)
        got = bvh.intersect_bvh(b, *(torch.as_tensor(v) for v in soup),
                                torch.as_tensor(o), torch.as_tensor(d),
                                t_max=t_max)
        assert got == ref
        hits += bool(got[0])
    assert hits >= 5
