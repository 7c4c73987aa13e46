"""The port's accel.mxu (Möller–Trumbore as a matrix product) against the
JAX package's, and the worklist's mxu intersector against brute force at
JAX's own statistical bounds (tests/test_accel.py:1154-1185).

Same inputs (numpy, seeded) through both packages on the CPU. The table and
the features are elementwise f32 arithmetic: held at the standing rtol 1e-6
+ atol 2e-6 (XLA's CPU code contracts FMAs; ROADMAP §3). mxu_sweep's
"highest" sums its exact products in f64 and rounds once, where XLA sums
in f32, so t is held at rtol 1e-5 and at most 1% of the tests may flip at
the guards' edges. "high" (bf16 x 3) and "default" (bf16) are held against
"highest" at bounds set from their operands' precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import mxu as jmxu
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import mxu, worklist
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup
from tests.test_torch_kslots import _port, _unit_rays
from tests.test_torch_worklist import T, T_TOL, _one_torch_thread  # noqa: F401


def _inputs(rng, n_tris=300, s=16, n=64, g=4):
    """Items of 8 rays and g clusters; each ray is aimed from a random
    origin at a random point of a random triangle of its item's clusters,
    so that many tests pass."""
    jtris = random_soup(rng, n_tris)
    ja = jbuild(jtris, cluster_size=s)
    pa, ptris = _port(ja, jtris)
    cid = rng.integers(0, ja.num_clusters, (n // 8, g))
    v0, e1, e2 = (np.asarray(a) for a in (ja.v0, ja.e1, ja.e2))
    c = np.repeat(cid[:, rng.integers(0, g, n // 8)].diagonal(), 8)
    j = rng.integers(0, s, n)
    ab = rng.uniform(0.05, 0.45, (n, 2)).astype(np.float32)
    target = v0[c, j] + ab[:, :1] * e1[c, j] + ab[:, 1:] * e2[c, j]
    o, _ = _unit_rays(rng, n, 6.0)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ja, pa, ptris, o.reshape(-1, 8, 3), d.reshape(-1, 8, 3), cid


def _gathered(table, cid, g, s):
    """[items, 10, g * S, 4] of the items' clusters (the worklist's
    gather)."""
    wg = table[cid]                                  # [I, g, 10, S, 4]
    return wg.transpose(1, 2).reshape(cid.shape[0], 10, g * s, 4)


def test_table_and_features_match_jax(rng):
    ja, pa, _, o, d, _ = _inputs(rng)
    np.testing.assert_allclose(mxu.build_linear_table(pa).numpy(),
                               np.asarray(jmxu.build_linear_table(ja)),
                               **T_TOL)
    np.testing.assert_allclose(
        mxu.ray_features(T(o), T(d)).numpy(),
        np.asarray(jmxu.ray_features(jnp.asarray(o), jnp.asarray(d))),
        **T_TOL)


def test_mxu_sweep_highest_matches_jax(rng):
    ja, pa, _, o, d, cid = _inputs(rng, n=128)
    tm = rng.uniform(0.3, 12.0, o.shape[:2]).astype(np.float32)
    tm[:, ::3] = -1.0
    wj = np.asarray(jmxu.build_linear_table(ja))[cid]
    wj = np.moveaxis(wj, 1, 2).reshape(cid.shape[0], 10, -1, 4)
    gj = jmxu.ray_features(jnp.asarray(o), jnp.asarray(d))
    tj, okj = jmxu.mxu_sweep(gj, jnp.asarray(wj), 1e-3, jnp.asarray(tm))
    wt = _gathered(mxu.build_linear_table(pa), T(cid), 4, pa.cluster_size)
    tt, okt = mxu.mxu_sweep(mxu.ray_features(T(o), T(d)), wt, 1e-3, T(tm))
    okj, okt = np.asarray(okj), okt.numpy()
    assert okj.sum() > 20
    assert (okj != okt).mean() <= 0.01
    both = okj & okt
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(tj)[both],
                               rtol=1e-5)
    assert np.isinf(tt.numpy()[~okt]).all()


@pytest.mark.parametrize("precision,median_rtol,share_5e3,flips", [
    ("high", 1e-4, 0.99, 5e-3), ("default", 1e-2, 0.5, 1e-2)])
def test_lower_precisions_near_highest(rng, precision, median_rtol,
                                       share_5e3, flips):
    """bf16 x 3 keeps about 16 bits of each operand, bf16 alone 8, and the
    guards' cancellations amplify that on a few tests. Where both pass, the
    median relative t error against "highest" is below 1e-4 ("high") and
    1e-2 ("default"); "high" keeps JAX's mxu bounds (t within rtol 5e-3 on
    99% of the tests, passes flipping on fewer than 0.5%), "default" half
    of the tests within 5e-3 and flips below 1%. Neither product is
    "highest"'s."""
    _, pa, _, o, d, cid = _inputs(rng, n=256)
    tm = np.full(o.shape[:2], 20.0, np.float32)
    g = mxu.ray_features(T(o), T(d))
    wg = _gathered(mxu.build_linear_table(pa), T(cid), 4, pa.cluster_size)
    t_hi, ok_hi = mxu.mxu_sweep(g, wg, 1e-3, T(tm), "highest")
    t_lo, ok_lo = mxu.mxu_sweep(g, wg, 1e-3, T(tm), precision)
    assert ok_hi.sum() > 100
    assert (ok_hi != ok_lo).float().mean() < flips
    both = ok_hi & ok_lo
    rel = ((t_lo - t_hi).abs() / t_hi.abs())[both].numpy()
    assert np.median(rel) < median_rtol
    assert (rel <= 5e-3).mean() >= share_5e3
    assert not torch.equal(mxu.linear_product(g, wg, precision),
                           mxu.linear_product(g, wg, "highest"))


def test_unknown_precision_raises(rng):
    _, pa, _, o, d, cid = _inputs(rng)
    wg = _gathered(mxu.build_linear_table(pa), T(cid), 4, pa.cluster_size)
    with pytest.raises(ValueError, match="precision"):
        mxu.linear_product(mxu.ray_features(T(o), T(d)), wg, "fastest")


def test_worklist_mxu_closest_within_jax_bounds(rng):
    """tests/test_accel.py::test_mxu_intersector_statistical on the port:
    hits flip on fewer than 0.5% of the rays, t within rtol 5e-3 where
    both hit, the same triangle on more than 99%."""
    from tests.test_accel import random_rays

    tris = random_soup(rng, 500)
    ja = jbuild(tris, cluster_size=32)
    pa, ptris = _port(ja, tris)
    o, d = (np.array(a) for a in random_rays(rng, 512))
    ph = worklist.closest_hit_worklist(pa, T(o), T(d), 1e-3, float("inf"),
                                       intersector="mxu", block=64, group=4)
    bh = intersect.closest_hit(ptris, T(o), T(d), 1e-3, float("inf"))
    hit_m, hit_b = ph.hit.numpy(), bh.hit.numpy()
    assert hit_b.mean() > 0.05
    assert (hit_m != hit_b).mean() < 5e-3
    both = hit_m & hit_b
    np.testing.assert_allclose(ph.t.numpy()[both], bh.t.numpy()[both],
                               rtol=5e-3)
    assert (ph.tri.numpy()[both] == bh.tri.numpy()[both]).mean() > 0.99


@pytest.mark.parametrize("intersector", ["mxu", "mxu:high"])
def test_worklist_mxu_anyhit_within_jax_bounds(rng, intersector):
    """tests/test_accel.py::test_mxu_anyhit_statistical on the port (and
    its bf16 x 3 form): occlusion flips on fewer than 0.5% of the rays."""
    from tests.test_accel import random_rays

    tris = random_soup(rng, 300)
    ja = jbuild(tris, cluster_size=16)
    pa, ptris = _port(ja, tris)
    o, d = (np.array(a) for a in random_rays(rng, 256))
    tm = rng.uniform(0.3, 12.0, 256).astype(np.float32)
    pa_occ = worklist.any_hit_worklist(pa, T(o), T(d), 1e-3, T(tm),
                                       intersector=intersector, block=64,
                                       group=4)
    ba = intersect.any_hit(ptris, T(o), T(d), 1e-3, T(tm))
    assert ba.numpy().mean() > 0.02
    assert (pa_occ.numpy() != ba.numpy()).mean() < 5e-3
