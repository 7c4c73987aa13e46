"""The port's accel.pairs against the JAX package's and brute force.

Same inputs (numpy, seeded) through `path_tracer_ai_tpu.accel.pairs` and
`path_tracer_ai_tpu_torch.accel.pairs` on the CPU, where the pair tiles'
sweep is tile_sweep's plain version. hit, tri and occlusion must match
exactly; t within rtol 1e-6 plus atol 2e-6 (XLA's CPU code contracts FMAs,
eager torch does not; ROADMAP §3). Against the port's own brute force, t
is bitwise. The pair tables must equal JAX's on every live slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pairs as jpairs
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import pairs
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup

T = torch.as_tensor
T_TOL = dict(rtol=1e-6, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(rng, n_tris, s, spread=4.0):
    jtris = random_soup(rng, n_tris, spread=spread)
    ja = jbuild(jtris, cluster_size=s)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris), device="cpu")
    return ja, pa, ptris


def _rays(rng, n, spread=6.0, t_max=None, dead_every=0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = (np.full(n, np.inf, np.float32) if t_max is None
          else rng.uniform(*t_max, n).astype(np.float32))
    if dead_every:
        tm[::dead_every] = -1.0
    return o, d, tm


def _closest_both(ja, pa, o, d, tm, **kw):
    hj = jpairs.closest_hit_pairs(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                  jnp.asarray(tm), **kw)
    ht = pairs.closest_hit_pairs(pa, T(o), T(d), 1e-3, T(tm), **kw)
    return hj, ht


def _check_closest(ja, pa, ptris, o, d, tm, **kw):
    hj, ht = _closest_both(ja, pa, o, d, tm, **kw)
    assert np.asarray(hj.hit).mean() > 0.02
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(ht.hit.numpy(), bf.hit.numpy())
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
    hit = bf.hit.numpy()
    np.testing.assert_array_equal(ht.tri.numpy()[hit], bf.tri.numpy()[hit])


# (soup triangles, cluster size, spread, rays, ray spread, options): the
# JAX package's TestPairTraversal cases (tests/test_accel.py)
CLOSEST_CASES = {
    "plain": (500, 32, 4.0, 300, 6.0, {}),
    "small_tiles": (300, 16, 4.0, 200, 6.0,
                    dict(tile_rays=8, tile_chunk=2, row_chunk=64)),
    "cap_overflow": (300, 8, 2.0, 100, 3.0, dict(cap=2)),
    "budget_overflow": (400, 8, 2.0, 128, 3.0,
                        dict(pair_budget=1, tile_chunk=4)),
    "budget_overflow_compacted": (400, 8, 2.0, 256, 3.0,
                                  dict(pair_budget=1, tile_chunk=4,
                                       fallback_compact=200)),
}


@pytest.mark.parametrize("case", sorted(CLOSEST_CASES))
def test_closest_hit_pairs_matches_jax(rng, case):
    n_tris, s, spread, n, rspread, kw = CLOSEST_CASES[case]
    ja, pa, ptris = _scene(rng, n_tris, s, spread)
    o, d, tm = _rays(rng, n, rspread)
    _check_closest(ja, pa, ptris, o, d, tm, **kw)


def test_closest_hit_pairs_dead_rays_and_per_ray_tmax(rng):
    ja, pa, ptris = _scene(rng, 400, 32)
    o, d, tm = _rays(rng, 256, t_max=(0.3, 12.0), dead_every=3)
    _check_closest(ja, pa, ptris, o, d, tm)
    ht = pairs.closest_hit_pairs(pa, T(o), T(d), 1e-3, T(tm))
    assert not ht.hit.numpy()[::3].any()


@pytest.mark.parametrize("kw", [{}, dict(cap=2), dict(pair_budget=1)])
def test_any_hit_pairs_matches_jax(rng, kw):
    ja, pa, ptris = _scene(rng, 300, 16, spread=2.0 if kw else 4.0)
    o, d, tm = _rays(rng, 150, 3.0 if kw else 6.0, t_max=(0.3, 12.0),
                     dead_every=7)
    occ_j = np.asarray(jpairs.any_hit_pairs(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm), **kw))
    occ_t = pairs.any_hit_pairs(pa, T(o), T(d), 1e-3, T(tm), **kw)
    assert 0.02 < occ_j.mean() < 0.98
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    brute = intersect.any_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(occ_t.numpy(), brute.numpy())


@pytest.mark.parametrize("kw", [dict(), dict(cap=3, tile_rays=8,
                                             row_chunk=32, pair_align=2),
                                dict(pair_budget=1)])
def test_build_pair_tables_equal_jax(rng, kw):
    """Every table equal to JAX's on its live slots: pair_ray, the tile's
    cluster on the real tiles, dst / n_cand / overflow on every ray."""
    ja, pa, _ = _scene(rng, 400, 16)
    o, d, tm = _rays(rng, 200, t_max=(0.3, 12.0), dead_every=5)
    tj = jpairs.build_pair_tables(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                  jnp.asarray(tm), **kw)
    tt = pairs.build_pair_tables(pa, T(o), T(d), 1e-3, T(tm), **kw)
    n_tiles = int(tj.n_tiles)
    assert int(tt.n_tiles) == n_tiles > 0
    t = kw.get("tile_rays", 128)
    np.testing.assert_array_equal(tt.pair_ray.numpy(), np.asarray(tj.pair_ray))
    np.testing.assert_array_equal(tt.tile_cluster.numpy()[:n_tiles],
                                  np.asarray(tj.tile_cluster)[:n_tiles])
    np.testing.assert_array_equal(tt.dst.numpy(), np.asarray(tj.dst))
    np.testing.assert_array_equal(tt.n_cand.numpy(), np.asarray(tj.n_cand))
    np.testing.assert_array_equal(tt.overflow.numpy(),
                                  np.asarray(tj.overflow))
    assert tt.pair_ray.shape[0] % t == 0
    assert (tt.n_cand.numpy()[::5] == 0).all()  # dead rays own no pairs


def test_pair_tiles_go_to_one_tile_sweep(rng, monkeypatch):
    """All real tiles of a wave are one tile_sweep call of shape
    [n_tiles, 8, tile_rays] with one cluster a tile; pad lanes go in dead."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    ja, pa, ptris = _scene(rng, 500, 32)
    o, d, tm = _rays(rng, 300)
    calls = []
    real = cuda_ctiles.tile_sweep

    def spy(tri_pack, rays_pack, tile_cid):
        calls.append((tuple(rays_pack.shape), tuple(tile_cid.shape),
                      int((rays_pack[:, 6] < 0).sum())))
        return real(tri_pack, rays_pack, tile_cid)

    monkeypatch.setattr(cuda_ctiles, "tile_sweep", spy)
    tables = pairs.build_pair_tables(pa, T(o), T(d), 1e-3, T(tm))
    pairs.closest_hit_pairs(pa, T(o), T(d), 1e-3, T(tm))
    n_tiles = int(tables.n_tiles)
    assert calls[0][:2] == ((n_tiles, 8, 128), (n_tiles,))
    assert calls[0][2] == n_tiles * 128 - int((tables.pair_ray >= 0).sum())
    _check_closest(ja, pa, ptris, o, d, tm)
