"""The port's perray queries (accel.traverse: _perray_candidates,
closest_hit_perray, any_hit_perray) against the JAX package's and brute
force, and the "perray" backend's chunking.

Same inputs (numpy, seeded) through `path_tracer_ai_tpu.accel.traverse`
and the port's. The candidate tables, hit, tri and occlusion must match
exactly; t within rtol 1e-6 plus atol 2e-6 (XLA's CPU code contracts FMAs,
eager torch does not; ROADMAP §3). The perray tie rule is the packet
cascade's (the first slot at the minimum t of a group wins, a later group
only with a strictly smaller t), so against brute force t is bitwise and
tri is held where no other triangle reaches the same t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu_torch.accel import cuda_ctiles, traverse
from path_tracer_ai_tpu_torch.engine import intersect, wavefront
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)


@pytest.mark.parametrize("order_mode", ["id", "entry"])
def test_perray_candidates_match_jax(rng, order_mode):
    """(order, n_cand, entry, overflow) bitwise, every slot; cap 4 below
    the busiest rays' counts, row chunks of 64."""
    ja, pa, _ = _scene(rng, 500, 16)
    o, d, tm = _rays(rng, 200)
    tm[1::2] = np.inf
    tj = jtraverse._perray_candidates(ja, jnp.asarray(o), jnp.asarray(d),
                                      1e-3, jnp.asarray(tm), 4, row_chunk=64,
                                      order_mode=order_mode)
    tt = traverse._perray_candidates(pa, T(o), T(d), 1e-3, T(tm), 4,
                                     row_chunk=64, order_mode=order_mode)
    assert bool(tt[3].any()) and int(tt[1].max()) == 4
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (soup triangles, cluster size, rays, options)
CASES = {
    "plain": (500, 16, 256, {}),
    # cap=2: most rays overflow to the packet fallback
    "cap2": (500, 16, 256, dict(cap=2)),
    "group3": (600, 8, 192, dict(cap=12, group_size=3, fallback_block=32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perray_matches_jax(rng, case):
    """closest_hit_perray and any_hit_perray against JAX and brute force:
    dead rays, per-ray t_max, t_min."""
    n_tris, s, n, kw = CASES[case]
    ja, pa, ptris = _scene(rng, n_tris, s)
    o, d, tm = _rays(rng, n)
    tm[1::5] = np.inf
    for t_min in (1e-3, 0.5):
        args_j = (ja, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(tm))
        args_t = (pa, T(o), T(d), t_min, T(tm))
        hj = jtraverse.closest_hit_perray(*args_j, **kw)
        ht = traverse.closest_hit_perray(*args_t, **kw)
        assert np.asarray(hj.hit).mean() > 0.03
        np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
        np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
        np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
        bf = intersect.closest_hit(ptris, *args_t[1:])
        np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
        occ_j = np.asarray(jtraverse.any_hit_perray(*args_j, **kw))
        occ_t = traverse.any_hit_perray(*args_t, **kw)
        np.testing.assert_array_equal(occ_t.numpy(), occ_j)
        np.testing.assert_array_equal(
            occ_t.numpy(), intersect.any_hit(ptris, *args_t[1:]).numpy())


def test_perray_coplanar_cluster(rng):
    """Coplanar triangles (a flat cluster box) stay candidates: the
    inclusive slab; exact against brute force."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters

    k = 48
    v0 = np.concatenate([rng.uniform(-3, 3, (k, 2)), np.zeros((k, 1))],
                        1).astype(np.float32)
    tris = SimpleNamespace(v0=T(v0), v1=T(v0 + np.float32([0.7, 0, 0])),
                           v2=T(v0 + np.float32([0, 0.7, 0])))
    pa = build_clusters(tris, cluster_size=16, device="cpu")
    n = 128
    o = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        np.full((n, 1), 2.0)], 1).astype(np.float32)
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    args = (T(o), T(d), 1e-3, T(np.full(n, np.inf, np.float32)))
    ht = traverse.closest_hit_perray(pa, *args)
    bf = intersect.closest_hit(tris, *args)
    assert bf.hit.numpy().mean() > 0.2
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
    np.testing.assert_array_equal(traverse.any_hit_perray(pa, *args).numpy(),
                                  bf.hit.numpy())


def test_perray_backend_chunks_do_not_change_results(rng, monkeypatch):
    """The "perray" backend's PERRAY_CHUNK: a wave of 700 rays in chunks
    of 128 (the last one short) gives the bits of one whole-wave query."""
    _, pa, _ = _scene(rng, 400, 16)
    o, d, tm = _rays(rng, 700)
    pack = cuda_ctiles.pack_tris(pa)
    whole = wavefront.packet_backend(pa, 1, backend="perray",
                                     packs={("pack_tris", id(pa)): pack})
    h0 = whole[0](T(o), T(d), 1e-3, T(tm))
    occ0 = whole[1](T(o), T(d), T(tm))
    monkeypatch.setattr(wavefront, "PERRAY_CHUNK", 128)
    calls = []
    real = traverse.closest_hit_perray
    monkeypatch.setattr(traverse, "closest_hit_perray",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    closest, occlude = wavefront.packet_backend(pa, 1)
    h1 = closest(T(o), T(d), 1e-3, T(tm))
    assert len(calls) == 6
    for a, b in zip(h1, h0):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(occlude(T(o), T(d), T(tm)).numpy(),
                                  occ0.numpy())
    assert torch.isfinite(h1.t).float().mean() > 0.05
