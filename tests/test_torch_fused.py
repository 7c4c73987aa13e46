"""The port's fused cascades (accel.cuda_anyhit, accel.cuda_closest) against
the JAX package's (accel.pallas_anyhit, accel.pallas_closest, Pallas kernels
in interpret mode) and brute force, at tests/test_pallas.py's sizes.

On the CPU the port's wrappers run the plain versions of their kernels.
Triangle ids and occlusion must be equal; t is held at rtol 1e-6 +
atol 2e-6 against JAX (XLA's CPU code contracts FMAs, eager torch does not;
the file seeds its own generator, see tests/test_torch_sweep.py) and
bitwise against the port's brute force. Within the port `sub_skip`,
`early_skip`, `sort` and `kernel_chunk` never change a bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pallas_anyhit as janyhit
from path_tracer_ai_tpu.accel import pallas_closest as jclosest
from path_tracer_ai_tpu.accel import pallas_ctiles as jctiles
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import cuda_anyhit, cuda_closest, cuda_ctiles
from path_tracer_ai_tpu_torch.convert import (
    accel_from_numpy,
    check_packs_match,
)
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_rays, random_soup

T = torch.as_tensor
T_TOL = dict(rtol=1e-6, atol=2e-6)
I32_MAX = cuda_ctiles.I32_MAX


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _np(tree):
    return [np.asarray(a) for a in tree]


def _scene(rng, n_tris, s):
    jtris = random_soup(rng, n_tris)
    ja = jbuild(jtris, cluster_size=s)
    return dict(ja=ja, pa=accel_from_numpy(*_np(ja), device="cpu"), v0=np.asarray(jtris.v0),
                ptris=triangles_from_numpy(*_np(jtris), device="cpu"))


def _wave(rng, sc, n, dead_every=4, tmax=(0.5, 15.0)):
    """Half bounce-like rays (they leave points near the triangles), half
    random ones; every `dead_every`-th lane dead."""
    o, d = (np.array(a) for a in random_rays(rng, n))
    near = sc["v0"][rng.integers(0, sc["v0"].shape[0], n)] + \
        rng.standard_normal((n, 3)).astype(np.float32) * 0.05
    o[::2] = near[::2]
    tm = (np.full(n, np.inf, np.float32) if tmax is None
          else rng.uniform(*tmax, n).astype(np.float32))
    if dead_every:
        tm[::dead_every] = -1.0
    return o.astype(np.float32), d, tm


@pytest.mark.parametrize("s,n_tris", [(16, 600), (64, 200), (128, 300)])
def test_packs_bitwise(rng, s, n_tris):
    sc = _scene(rng, n_tris, s)
    jpack = np.asarray(jctiles.pack_tris(sc["ja"]))
    jdummy = np.asarray(janyhit.pack_tris_dummy(sc["ja"]))
    p16 = cuda_ctiles.pack_tris16(sc["pa"])
    assert p16.shape == (sc["pa"].num_clusters, 16, s)
    np.testing.assert_array_equal(p16.numpy().view(np.int32),
                                  jpack.view(np.int32))
    np.testing.assert_array_equal(
        cuda_anyhit.pack_tris_dummy(sc["pa"]).numpy().view(np.int32),
        jdummy.view(np.int32))
    assert cuda_ctiles.n_subs(s) == jctiles.n_subs(s) and cuda_ctiles.SUB == jctiles.SUB
    check_packs_match(sc["pa"], pack16=jpack, pack_dummy=jdummy)
    bad = jdummy.copy()
    bad[0, 10, 0] += 1.0
    with pytest.raises(ValueError):
        check_packs_match(sc["pa"], pack_dummy=bad)


def _block_inputs(rng, sc, n, block_size, sort_mode):
    """Packs, rays and the first two candidate groups of each block, from
    the port's own sort and cull."""
    o, d, tm = _wave(rng, sc, n)
    o, d, tm, _perm, n_cand, _entry, order_g = cuda_anyhit.prepare_fused_wave(
        sc["pa"], T(o), T(d), T(tm), block_size, True, sort_mode)
    rays = cuda_ctiles.pack_rays_tiles(o, d, tm, block_size, t_min=1e-3)
    # every cluster is some block's candidate: full groups AND dummy padding
    assert int(n_cand.max()) == sc["pa"].num_clusters
    # the live blocks and one of the all-dead padding blocks (the sort puts
    # those last): interpret mode pays per block
    keep = int((n_cand > 0).sum()) + 1
    assert keep < rays.shape[0] and bool((rays[keep - 1, 6] < 0).all())
    return (cuda_anyhit.pack_tris_dummy(sc["pa"]), rays[:keep].contiguous(),
            order_g[:keep])


@pytest.mark.parametrize("early_skip,sub_skip,s,n_tris", [
    (False, False, 64, 700), (True, False, 64, 700), (False, True, 64, 700),
    (True, True, 64, 700), (True, True, 128, 450)])
def test_block_anyhit_plain_matches_pallas_interpret(rng, early_skip,
                                                     sub_skip, s, n_tris):
    sc = _scene(rng, n_tris, s)
    pack, rays, order_g = _block_inputs(rng, sc, 512, 128, "dir")
    jpack = janyhit.pack_tris_dummy(sc["ja"])
    hits = 0
    for k in range(order_g.shape[1]):
        cid8 = order_g[:, k].reshape(-1).contiguous()
        before = cuda_anyhit.launches
        st = {}
        occ = cuda_anyhit.block_anyhit(pack, rays, cid8, early_skip=early_skip,
                                       sub_skip=sub_skip)
        occ_p = cuda_anyhit.block_anyhit_plain(pack, rays, cid8, early_skip,
                                               sub_skip, stats=st)
        assert cuda_anyhit.launches == before  # CPU tensors: plain version
        assert torch.equal(occ, occ_p)
        dense = rays.shape[0] * cuda_anyhit.GROUP * 128 * s
        assert st["tests"] <= dense
        assert st["lane_tests"] <= st["tests"]  # dead / occluded lanes
        if early_skip or sub_skip:
            assert st["tests"] < dense
        jo = janyhit.block_anyhit(jpack, jnp.asarray(rays.numpy()),
                                  jnp.asarray(cid8.numpy()), interpret=True,
                                  early_skip=early_skip, sub_skip=sub_skip)
        np.testing.assert_array_equal(occ.numpy(),
                                      np.asarray(jo)[:, 0, :] > 0.0)
        # the options are gates: same bits as the ungated sweep
        assert torch.equal(occ, cuda_anyhit.block_anyhit(pack, rays, cid8))
        hits += int(occ.sum())
    assert hits > 20


@pytest.mark.parametrize("s,n_tris", [(128, 450), (16, 600)])
def test_block_closest_plain_matches_pallas_interpret(rng, s, n_tris):
    sc = _scene(rng, n_tris, s)
    pack, rays, order_g = _block_inputs(rng, sc, 256, 128, "octorig")
    jpack = janyhit.pack_tris_dummy(sc["ja"])
    hits = 0
    for k in range(min(2, order_g.shape[1])):
        cid8 = order_g[:, k].reshape(-1).contiguous()
        st_on, st_off = {}, {}
        t_on, tri_on = cuda_closest.block_closest_plain(pack, rays, cid8, True,
                                                        stats=st_on)
        t_off, tri_off = cuda_closest.block_closest_plain(pack, rays, cid8,
                                                          False, stats=st_off)
        assert torch.equal(t_on.view(torch.int32), t_off.view(torch.int32))
        assert torch.equal(tri_on, tri_off)
        assert st_on["tests"] <= st_off["tests"]
        assert 0 < st_on["lane_tests"] <= st_on["tests"]  # live lanes only
        if cuda_ctiles.n_subs(s) > 1:
            assert st_on["tests"] < st_off["tests"]
        before = cuda_closest.launches
        t_w, tri_w = cuda_closest.block_closest(pack, rays, cid8)
        assert cuda_closest.launches == before
        assert torch.equal(t_w, t_on) and torch.equal(tri_w, tri_on)
        # (interpret mode's trace of the ungated S=128 kernel is slow: the
        # ungated JAX kernel is held at S=16 only)
        for sub_skip in ((True, False) if s == 16 else (True,)):
            jo = np.asarray(jclosest.block_closest(
                jpack, jnp.asarray(rays.numpy()), jnp.asarray(cid8.numpy()),
                interpret=True, sub_skip=sub_skip))
            np.testing.assert_array_equal(tri_on.numpy(),
                                          jo[:, 1, :].view(np.int32))
            np.testing.assert_allclose(t_on.numpy(), jo[:, 0, :], **T_TOL)
        hits += int((tri_on != I32_MAX).sum())
    assert hits > 10


def test_block_closest_ties_keep_min_tri():
    """Copies of one triangle within a cluster, across sub-slabs and across
    candidates resolve to the smallest id; the dummy cluster and a dead lane
    miss."""
    s = 64
    v0 = np.zeros((2, s, 3), np.float32)
    e1 = np.zeros((2, s, 3), np.float32)
    e2 = np.zeros((2, s, 3), np.float32)
    tri_id = np.full((2, s), -1, np.int32)
    for c, slot, tid in ((0, 3, 40), (0, 7, 12), (0, 50, 9), (1, 2, 5)):
        v0[c, slot] = (-1, -1, 0)
        e1[c, slot] = (2, 0, 0)
        e2[c, slot] = (0, 2, 0)
        tri_id[c, slot] = tid
    bb = np.zeros((2, 3), np.float32)
    acc = accel_from_numpy(bb, bb, v0, e1, e2, tri_id, bb[0], bb[0], bb, bb,
                           bb[None], bb[None], device="cpu")
    pack = cuda_anyhit.pack_tris_dummy(acc)
    o = np.tile([[-0.5, -0.5, -2.0]], (128, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (128, 1)).astype(np.float32)
    tm = np.full(128, np.inf, np.float32)
    tm[5] = -1.0
    rays = cuda_ctiles.pack_rays_tiles(T(o), T(d), T(tm), 128)
    for sub_skip in (True, False):
        for cids, want in (([0, 1, 2, 2, 2, 2, 2, 2], 5),
                           ([1, 0, 2, 2, 2, 2, 2, 2], 5),
                           ([0, 2, 2, 2, 2, 2, 2, 2], 9),
                           ([2] * 8, I32_MAX)):
            t, tri = cuda_closest.block_closest(
                pack, rays, torch.tensor(cids, dtype=torch.int32), sub_skip)
            assert tri[0, 0] == want
            assert t[0, 0] == (2.0 if want != I32_MAX else np.inf)
            assert tri[0, 5] == I32_MAX and t[0, 5] == np.inf
    occ = cuda_anyhit.block_anyhit(pack, rays,
                                   torch.tensor([2, 2, 1, 2, 2, 2, 2, 2],
                                                dtype=torch.int32),
                                   early_skip=True, sub_skip=True)
    assert occ[0, 0] and not occ[0, 5] and occ.sum() == 127


ANYHIT_VARIANTS = [dict(), dict(early_skip=True), dict(kernel_chunk=8),
                   dict(sort=False, early_skip=True), dict(sub_skip=True),
                   dict(sub_skip=True, early_skip=True)]
CASES = [  # n_tris, S, n_rays, dead_every, t_max
    (600, 16, 256, 4, (0.5, 15.0)),
    (300, 128, 173, None, 9.0),     # unaligned wave, scalar t_max
]


@pytest.mark.parametrize("n_tris,s,n,dead_every,tmax", CASES)
def test_any_hit_fused_matches_jax_and_bruteforce(rng, n_tris, s, n,
                                                  dead_every, tmax):
    sc = _scene(rng, n_tris, s)
    scalar = not isinstance(tmax, tuple)
    o, d, tm = _wave(rng, sc, n, dead_every, None if scalar else tmax)
    tm_t = tmax if scalar else T(tm)
    tm_full = torch.full((n,), float(tmax)) if scalar else T(tm)
    bf = intersect.any_hit(sc["ptris"], T(o), T(d), 1e-3, tm_full).numpy()
    assert 0.05 < bf.mean() < 0.95
    for kw in ANYHIT_VARIANTS:
        occ = cuda_anyhit.any_hit_fused(sc["pa"], T(o), T(d), 1e-3, tm_t, **kw)
        assert occ.shape == (n,)
        np.testing.assert_array_equal(occ.numpy(), bf, err_msg=str(kw))
    for kw in (dict(), dict(early_skip=True, sub_skip=True, sort=False)):
        jo = janyhit.any_hit_fused(
            sc["ja"], jnp.asarray(o), jnp.asarray(d), 1e-3,
            tmax if scalar else jnp.asarray(tm), interpret=True, **kw)
        np.testing.assert_array_equal(np.asarray(jo), bf, err_msg=str(kw))


CLOSEST_VARIANTS = [dict(sub_skip=False), dict(sort=False),
                    dict(kernel_chunk=8), dict(sub_skip=False, sort=False)]


@pytest.mark.parametrize("n_tris,s,n,dead_every,tmax", CASES)
def test_closest_hit_fused_matches_jax_and_bruteforce(rng, n_tris, s, n,
                                                      dead_every, tmax):
    sc = _scene(rng, n_tris, s)
    scalar = not isinstance(tmax, tuple)
    o, d, tm = _wave(rng, sc, n, dead_every, None if scalar else tmax)
    tm_t = np.inf if scalar else T(tm)
    tm_full = torch.full((n,), np.inf) if scalar else T(tm)
    fh = cuda_closest.closest_hit_fused(sc["pa"], T(o), T(d), 1e-3, tm_t)
    bf = intersect.closest_hit(sc["ptris"], T(o), T(d), 1e-3, tm_full)
    m = bf.hit.numpy()
    assert m.mean() > 0.05
    np.testing.assert_array_equal(fh.hit.numpy(), m)
    np.testing.assert_array_equal(fh.t.numpy(), bf.t.numpy())
    np.testing.assert_array_equal(fh.tri.numpy()[m], bf.tri.numpy()[m])
    assert (fh.tri.numpy()[~m] == -1).all()
    for kw in CLOSEST_VARIANTS:
        fv = cuda_closest.closest_hit_fused(sc["pa"], T(o), T(d), 1e-3, tm_t,
                                            **kw)
        assert torch.equal(fv.t, fh.t) and torch.equal(fv.tri, fh.tri), kw
    jh = jclosest.closest_hit_fused(
        sc["ja"], jnp.asarray(o), jnp.asarray(d), 1e-3,
        np.inf if scalar else jnp.asarray(tm), interpret=True)
    np.testing.assert_array_equal(fh.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(fh.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_allclose(fh.t.numpy(), np.asarray(jh.t), **T_TOL)


def test_all_dead_waves(rng):
    sc = _scene(rng, 200, 64)
    o, d, _ = _wave(rng, sc, 128)
    dead = torch.full((128,), -1.0)
    assert not cuda_anyhit.any_hit_fused(sc["pa"], T(o), T(d), 1e-3, dead).any()
    fh = cuda_closest.closest_hit_fused(sc["pa"], T(o), T(d), 1e-3, dead)
    assert not fh.hit.any() and (fh.tri == -1).all()


def test_cascades_sweep_active_blocks_only(rng, monkeypatch):
    """Retired blocks are not swept again: the blocks handed to the kernel
    wrapper shrink as the cascade goes on, and never exceed kernel_chunk."""
    sc = _scene(rng, 600, 16)
    o, d, tm = _wave(rng, sc, 64 * 128, dead_every=5)
    sizes = []
    real = cuda_anyhit.block_anyhit

    def spy(tri_pack, rays_pack, cid8, **kw):
        sizes.append(rays_pack.shape[0])
        return real(tri_pack, rays_pack, cid8, **kw)

    monkeypatch.setattr(cuda_anyhit, "block_anyhit", spy)
    occ = cuda_anyhit.any_hit_fused(sc["pa"], T(o), T(d), 1e-3, T(tm),
                                    kernel_chunk=16, early_skip=True)
    bf = intersect.any_hit(sc["ptris"], T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(occ.numpy(), bf.numpy())
    assert max(sizes) <= 16 and min(sizes) < 16


@pytest.mark.parametrize("sort", [True, False])
def test_fused_exact_cull_equals_conservative(rng, sort):
    """exact_cull=16 (once raising as unported) in both fused cascades:
    the same occlusion and the same (hit, t, tri) as the conservative
    cull, and brute force's."""
    sc = _scene(rng, 600, 16)
    o, d, tm = _wave(rng, sc, 64 * 40)
    args = (sc["pa"], T(o), T(d), 1e-3, T(tm))
    occ = cuda_anyhit.any_hit_fused(*args, exact_cull=16, sort=sort)
    assert torch.equal(occ, cuda_anyhit.any_hit_fused(*args, sort=sort))
    assert torch.equal(occ, intersect.any_hit(sc["ptris"], *args[1:]))
    got = cuda_closest.closest_hit_fused(*args, exact_cull=16, sort=sort)
    ref = cuda_closest.closest_hit_fused(*args, sort=sort)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    bf = intersect.closest_hit(sc["ptris"], *args[1:])
    assert torch.equal(got.t, bf.t) and bool(got.hit.any())


def test_unported_options_and_bad_inputs_raise(rng):
    meta = dict(device="meta")
    args = (torch.empty((3, 16, 64), **meta), torch.empty((2, 8, 128), **meta),
            torch.empty((16,), dtype=torch.int32, **meta))
    with pytest.raises(ValueError):
        cuda_anyhit.block_anyhit(*args)
    with pytest.raises(ValueError):
        cuda_closest.block_closest(*args)
