"""The plain version of the port's tile sweep against the Pallas kernel it
replaces (`pallas_ctiles.tile_sweep`, interpret mode), the way
tests/test_pallas.py holds that kernel against the XLA sweep: dead slots,
padding triangles, triangle-id ties, T = 128 and T = 64. tri must be
equal; t within rtol 1e-6 (interpret mode and eager torch contract FMAs
differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pallas_ctiles as pc
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from tests.test_accel import random_rays, random_soup


def _accel_pair(rng, n_tris, s):
    ja = jbuild(random_soup(rng, n_tris), cluster_size=s)
    return ja, accel_from_numpy(*(np.asarray(a) for a in ja))


@pytest.mark.parametrize("t_lanes,s", [(128, 128), (64, 128), (128, 256)])
def test_tile_sweep_plain_matches_pallas_interpret(rng, t_lanes, s):
    ja, pa = _accel_pair(rng, 300, s)
    c = ja.num_clusters
    nt = 2 * pc.GROUP
    n = nt * t_lanes
    o, d = random_rays(rng, n)
    tmax = rng.uniform(0.5, 20.0, n).astype(np.float32)
    tmax[::5] = -1.0                                   # dead slots
    tile_cid = np.repeat(rng.integers(0, c, nt // pc.GROUP),
                         pc.GROUP).astype(np.int32)
    # the last cluster holds padding slots (300 % s != 0)
    tile_cid[-pc.GROUP:] = c - 1
    t_j, tri_j = pc.tile_sweep(pc.pack_tris(ja),
                               pc.pack_rays_tiles(o, d, jnp.asarray(tmax),
                                                  t_lanes),
                               jnp.asarray(tile_cid), interpret=True)
    rays = cuda_ctiles.pack_rays_tiles(torch.as_tensor(np.asarray(o)),
                                       torch.as_tensor(np.asarray(d)),
                                       torch.as_tensor(tmax), t_lanes)
    launches = cuda_ctiles.launches
    t_t, tri_t = cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris(pa), rays,
                                        torch.as_tensor(tile_cid))
    assert cuda_ctiles.launches == launches  # CPU tensors: plain version
    assert (np.asarray(tri_j) != cuda_ctiles.I32_MAX).sum() > 0
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(tri_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6)


def test_tile_sweep_ties_keep_min_tri():
    """Duplicate triangles (equal t) resolve to the smaller global id, and
    a dead lane and an all-padding cluster miss."""
    s, t_lanes = 128, 64
    v0 = np.zeros((2, s, 3), np.float32)
    e1 = np.zeros((2, s, 3), np.float32)
    e2 = np.zeros((2, s, 3), np.float32)
    tri_id = np.full((2, s), -1, np.int32)
    for slot, tid in ((3, 40), (7, 12), (9, 99)):  # the same triangle 3 times
        v0[0, slot] = (-1, -1, 0)
        e1[0, slot] = (2, 0, 0)
        e2[0, slot] = (0, 2, 0)
        tri_id[0, slot] = tid
    bb = np.zeros((2, 3), np.float32)
    acc = accel_from_numpy(bb, bb, v0, e1, e2, tri_id, bb[0], bb[0], bb, bb,
                           bb[None], bb[None])
    o = np.tile([[-0.5, -0.5, -2.0]], (2 * t_lanes, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (2 * t_lanes, 1)).astype(np.float32)
    tm = np.full(2 * t_lanes, np.inf, np.float32)
    tm[5] = -1.0
    rays = cuda_ctiles.pack_rays_tiles(torch.as_tensor(o), torch.as_tensor(d),
                                       torch.as_tensor(tm), t_lanes)
    t, tri = cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris(acc), rays,
                                    torch.tensor([0, 1], dtype=torch.int32))
    assert tri[0, 0] == 12 and t[0, 0] == 2.0
    assert tri[0, 5] == cuda_ctiles.I32_MAX and t[0, 5] == np.inf
    assert (tri[1] == cuda_ctiles.I32_MAX).all() and torch.isinf(t[1]).all()


def test_pack_rows_match_pallas_pack(rng):
    ja, pa = _accel_pair(rng, 200, 128)
    np.testing.assert_array_equal(cuda_ctiles.pack_tris(pa).numpy(),
                                  np.asarray(pc.pack_tris(ja))[:, :10])


def test_tile_sweep_wrapper_rejects_other_devices():
    meta = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        cuda_ctiles.tile_sweep(torch.empty((1, 10, 128), device="meta"), meta,
                               torch.empty((1,), dtype=torch.int32,
                                           device="meta"))
