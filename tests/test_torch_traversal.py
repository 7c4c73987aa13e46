"""The port's main-path traversals against the JAX package's and brute force.

any_hit_packets must match exactly; closest_hit_ctiles must match hit and
tri exactly, and t within rtol 1e-6 plus atol 2e-6. XLA's CPU code
contracts FMAs and eager torch does not; on short bounce rays (t ~ 0.02)
that moves t by a few ulps of the scene's coordinates (~4.0), which is a
large relative error. The JAX package's own two sweeps (XLA and the Pallas
kernel in interpret mode) differ by up to 1.8e-6 absolute, 1.1e-6
relative, on these same rays; the port differs from its XLA sweep by up
to 1.5e-6 absolute. Against the port's own brute force, t is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import ctiles as jctiles
from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu.accel.morton import morton3d as jmorton
from path_tracer_ai_tpu_torch.accel import ctiles, traverse
from path_tracer_ai_tpu_torch.accel.morton import morton3d
from path_tracer_ai_tpu_torch.accel.worklist import _extract_k
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup

T = torch.as_tensor
T_TOL = dict(rtol=1e-6, atol=2e-6)


def _setup(rng, n_tris, s, n_rays, dead_every=6):
    jtris = random_soup(rng, n_tris)
    ja = jbuild(jtris, cluster_size=s)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja))
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris))
    # bounce-like rays: leave triangle surfaces in random directions
    v0 = np.asarray(jtris.v0)
    o = (v0[rng.integers(0, n_tris, n_rays)]
         + rng.standard_normal((n_rays, 3)).astype(np.float32) * 0.05)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 12.0, n_rays).astype(np.float32)
    tm[::dead_every] = -1.0
    return ja, pa, ptris, o.astype(np.float32), d, tm


@pytest.mark.parametrize("sort", [True, False])
def test_any_hit_packets_matches_jax(rng, sort):
    ja, pa, ptris, o, d, tm = _setup(rng, 1500, 128, 64 * 96)
    occ_j = np.asarray(jtraverse.any_hit_packets(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm),
        block_size=64, group_size=2, sort=sort))
    occ_t = traverse.any_hit_packets(pa, T(o), T(d), 1e-3, T(tm),
                                     block_size=64, group_size=2, sort=sort)
    assert 0.05 < occ_j.mean() < 0.95
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    brute = intersect.any_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(occ_t.numpy(), brute.numpy())


def _closest_kw(cap, fallback_compact):
    # the port's block (8) and tile_blocks (16) are the reference defaults
    return dict(cap=cap, tile_chunk=4, fallback_compact=fallback_compact)


@pytest.mark.parametrize("sort", [True, False])
def test_closest_hit_ctiles_matches_jax(rng, sort):
    ja, pa, ptris, o, d, tm = _setup(rng, 1500, 256, 2048)
    tm[1::6] = np.inf
    kw = _closest_kw(48, 1 << 12)
    hj = jctiles.closest_hit_ctiles(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                    jnp.asarray(tm), sort=sort,
                                    fallback_sorted=True, **kw)
    ht = ctiles.closest_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm), sort=sort,
                                   **kw)
    assert np.asarray(hj.hit).mean() > 0.2
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)


@pytest.mark.parametrize("fallback_compact", [1 << 12, 100])
def test_closest_overflow_fallback(rng, fallback_compact):
    """cap=2 sends most blocks to the overflow fallback; compact 100 makes
    it run in several chunks. Against JAX and against brute force."""
    ja, pa, ptris, o, d, tm = _setup(rng, 1500, 128, 1024)
    tm[1::5] = np.inf
    kw = _closest_kw(2, fallback_compact)
    ht = ctiles.closest_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm), **kw)
    hj = jctiles.closest_hit_ctiles(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                    jnp.asarray(tm), fallback_sorted=True,
                                    **kw)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(ht.hit.numpy(), bf.hit.numpy())
    np.testing.assert_array_equal(ht.tri.numpy()[bf.hit.numpy()],
                                  bf.tri.numpy()[bf.hit.numpy()])
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())


@pytest.mark.parametrize("mode", ["dir", "octorig"])
def test_sort_keys_match_jax(rng, mode):
    ja, pa, _, o, d, tm = _setup(rng, 300, 128, 4096)
    kj = np.asarray(jtraverse._sort_keys(ja, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tm), mode=mode))
    kt = traverse._sort_keys(pa, T(o), T(d), T(tm), mode=mode)
    np.testing.assert_array_equal(kt.numpy(), kj.astype(np.int64))
    np.testing.assert_array_equal(
        torch.argsort(kt, stable=True).numpy(), np.asarray(jnp.argsort(kj)))
    for bits in (3, 6, 7, 9):
        np.testing.assert_array_equal(
            morton3d(T(o), pa.scene_min, pa.scene_max, bits).numpy(),
            np.asarray(jmorton(jnp.asarray(o), ja.scene_min, ja.scene_max,
                               bits)).astype(np.int32))


def test_block_candidates_match_jax(rng):
    ja, pa, _, o, d, tm = _setup(rng, 800, 128, 64 * 40)
    ob, db, tb = o.reshape(40, 64, 3), d.reshape(40, 64, 3), tm.reshape(40, 64)
    oj, nj, ej = jtraverse._block_candidates(ja, jnp.asarray(ob),
                                             jnp.asarray(db), jnp.asarray(tb))
    ot, nt, et = traverse._block_candidates(pa, T(ob), T(db), T(tb))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_extract_k_ascending(rng):
    cand = rng.uniform(size=(50, 70)) < 0.2
    got = _extract_k(T(cand), 8, 69).numpy()
    for row, g in zip(cand, got):
        ids = np.nonzero(row)[0][:8]
        np.testing.assert_array_equal(g[:ids.size], ids)
        assert (g[ids.size:] == 69).all()
