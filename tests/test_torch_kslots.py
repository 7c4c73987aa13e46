"""The port's accel.kslots against the JAX package's and brute force: the
bitmask extraction, the per-ray slab with per-ray boxes, the cull tables
(phantom children included), the K-slot sweep's plain version and both
queries on every case of tests/test_accel.py::TestKslotsTraversal.

Same inputs (numpy, seeded) through `path_tracer_ai_tpu.accel.kslots` and
the port's, where the sweep is kslot_sweep's plain version. hit, tri,
occlusion, the bitmask words, peeled positions, slab flags and tables must
match exactly; t within rtol 1e-6 plus atol 2e-6 (XLA's CPU code contracts
FMAs, eager torch does not; ROADMAP §3). Against the port's own brute
force, t is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import kslots as jkslots
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu.accel.traverse import _mt_sweep
from path_tracer_ai_tpu.core.types import triangles_from_numpy as jtris_np
from path_tracer_ai_tpu_torch.accel import (
    cuda_ctiles,
    cuda_cull,
    cuda_kslots,
    kslots,
)
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup
from tests.test_torch_worklist import T, T_TOL, _one_torch_thread  # noqa: F401


def _port(ja, jtris):
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris),
                                 device="cpu")
    return pa, ptris


def _unit_rays(rng, n, spread):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _grid_tris(n_side, offset):
    """n_side^2 right triangles tiling the plane y = 0 from `offset`."""
    cells = [([i + offset, 0, j + offset], [i + offset + 1, 0, j + offset],
              [i + offset, 0, j + offset + 1])
             for i in range(n_side) for j in range(n_side)]
    v = [np.asarray([c[k] for c in cells], np.float32) for k in range(3)]
    t = len(cells)
    nrm = np.tile([[0, 1, 0]], (t, 1)).astype(np.float32)
    uv = np.zeros((t, 2), np.float32)
    return jtris_np(*v, nrm, nrm, nrm, uv, uv, uv, np.zeros(t, np.int32))


# TestKslotsTraversal's cases: (scene, accel build, rays, t_max, options)
def _case(name, rng):
    tmax = np.inf
    if name == "default":
        tris = random_soup(rng, 600)
        acc = dict(cluster_size=16, super_size=4)
        o, d = _unit_rays(rng, 300, 6.0)
        kw = {}
    elif name == "flat_level":
        tris = random_soup(rng, 300)
        acc = dict(cluster_size=16)
        o, d = _unit_rays(rng, 200, 6.0)
        kw = dict(levels=1, row_chunk=64)
    elif name in ("super_overflow", "cluster_overflow"):
        tris = random_soup(rng, 800 if name == "super_overflow" else 600,
                           spread=2.0)
        acc = dict(cluster_size=8, super_size=4)
        o, d = _unit_rays(rng, 128, 3.0)
        kw = (dict(k_supers=2, k_clusters=6) if name == "super_overflow"
              else dict(k_supers=16, k_clusters=2))
    elif name == "per_ray_tmax_dead":
        tris = random_soup(rng, 400)
        acc = dict(cluster_size=16, super_size=4)
        o, d = _unit_rays(rng, 256, 6.0)
        tmax = rng.uniform(0.3, 12.0, 256).astype(np.float32)
        tmax[::3] = -1.0
        kw = {}
    elif name == "axis_parallel_on_slab_planes":
        tris = _grid_tris(4, 0.0)
        acc = dict(cluster_size=4, super_size=2)
        o = np.asarray([[0.0, 1.0, 0.5], [2.0, 1.0, 1.5], [0.5, 1.0, 0.0]],
                       np.float32)
        d = np.asarray([[0, -1, 0]] * 3, np.float32)
        kw = {}
    else:  # coplanar_flat_aabb
        tris = _grid_tris(8, -4.0)
        acc = dict(cluster_size=16, super_size=2)
        o = rng.uniform(-3.5, 3.5, (64, 3)).astype(np.float32)
        o[:, 1] = 2.0
        d = rng.standard_normal((64, 3)).astype(np.float32)
        d[:, 1] = -np.abs(d[:, 1]) - 0.5
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        kw = {}
    tmax = np.broadcast_to(np.asarray(tmax, np.float32), (o.shape[0],))
    return tris, jbuild(tris, **acc), o, d, tmax.copy(), kw


CASES = ["default", "flat_level", "super_overflow", "cluster_overflow",
         "per_ray_tmax_dead", "axis_parallel_on_slab_planes",
         "coplanar_flat_aabb"]


@pytest.mark.parametrize("case", CASES)
def test_kslots_queries_match_jax(rng, case):
    jtris, ja, o, d, tm, kw = _case(case, rng)
    pa, ptris = _port(ja, jtris)
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), 1e-3, T(tm))
    hj = jkslots.closest_hit_kslots(*args_j, **kw)
    ht = kslots.closest_hit_kslots(*args_t, **kw)
    assert np.asarray(hj.hit).any()
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, *args_t[1:])
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
    np.testing.assert_array_equal(ht.tri.numpy()[bf.hit.numpy()],
                                  bf.tri.numpy()[bf.hit.numpy()])
    occ_j = np.asarray(jkslots.any_hit_kslots(*args_j, **kw))
    occ_t = kslots.any_hit_kslots(*args_t, **kw)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(occ_t.numpy(),
                                  intersect.any_hit(ptris, *args_t[1:]).numpy())


def test_overflow_cases_take_the_fallback(rng):
    """The two overflow cases of TestKslotsTraversal overflow some rays for
    the reason each names, and the counts say so."""
    for case, key in (("super_overflow", "over_supers"),
                      ("cluster_overflow", "over_clusters")):
        jtris, ja, o, d, tm, kw = _case(case, rng)
        pa, _ = _port(ja, jtris)
        kslots.reset_overflow_counts()
        kslots.any_hit_kslots(pa, T(o), T(d), 1e-3, T(tm), **kw)
        counts = kslots.read_overflow_counts()
        assert counts["queries"] == 1 and counts[key] > 0
        assert counts["rays"] == o.shape[0]


@pytest.mark.parametrize("n_cols,k", [(77, 8), (32, 5), (31, 40), (96, 12)])
def test_pack_bits_and_peel_k_match_jax(rng, n_cols, k):
    """W 1 (31 and 32 columns) and 3 (77, 96), bit 31 and 32 set in every
    other row, rows with fewer than k bits, and empty rows."""
    cand = rng.random((60, n_cols)) < 0.15
    cand[::2, min(31, n_cols - 1)] = True
    if n_cols > 32:
        cand[1::2, 32] = True
    cand[5] = False
    wj = np.asarray(jkslots._pack_bits(jnp.asarray(cand))).astype(np.int64)
    wt = kslots._pack_bits(torch.as_tensor(cand))
    np.testing.assert_array_equal(wt.numpy(), wj)
    pj = np.asarray(jkslots._peel_k(jnp.asarray(wj.astype(np.uint32)), k,
                                    n_cols))
    pt = kslots._peel_k(wt, k, n_cols)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), pj)


def _slab_inputs(rng, n, k):
    o, d = _unit_rays(rng, n, 4.0)
    d[::5, 0] = 0.0                     # axis-parallel rays: 0 * inf NaNs
    c = rng.uniform(-4, 4, (n, k, 3)).astype(np.float32)
    h = rng.uniform(0.0, 1.5, (n, k, 3)).astype(np.float32)
    bmin, bmax = c - h, c + h
    bmin[:, ::4, 1] = bmax[:, ::4, 1]  # flat boxes
    o[::5, 0] = bmin[::5, 0, 0]        # origins on a slab plane
    bmin[:, 3], bmax[:, 3] = 3e37, -3e37  # the padding children's boxes
    lo = np.full(n, 1e-3, np.float32)
    hi = rng.uniform(-1.0, 12.0, n).astype(np.float32)
    return o, d, bmin, bmax, lo, hi


def test_ray_slab_per_ray_boxes_match_jax(rng):
    """[N, K, 3] boxes (the gathered children) give JAX's [N, K] flags, the
    inverted padding boxes passing wherever the interval is non-empty."""
    o, d, bmin, bmax, lo, hi = _slab_inputs(rng, 128, 9)
    ref = np.asarray(jkslots._ray_slab(*(jnp.asarray(a) for a in
                                         (bmin, bmax, o, d, lo, hi))))
    got = kslots._ray_slab(*(T(a) for a in (bmin, bmax, o, d, lo, hi)))
    assert got.shape == (128, 9)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[:, 3].numpy(), hi >= lo)


def test_ray_slab_shared_boxes_unchanged(rng):
    """The [K, 3] form (ctiles' cull) keeps its bits: JAX's, and the same
    as the boxes broadcast to every ray."""
    o, d, bmin, bmax, lo, hi = _slab_inputs(rng, 64, 9)
    bmin, bmax = bmin[0], bmax[0]
    ref = np.asarray(jkslots._ray_slab(*(jnp.asarray(a) for a in
                                         (bmin, bmax, o, d, lo, hi))))
    got = kslots._ray_slab(*(T(a) for a in (bmin, bmax, o, d, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), ref)
    per_ray = kslots._ray_slab(T(np.broadcast_to(bmin, (64, 9, 3)).copy()),
                               T(np.broadcast_to(bmax, (64, 9, 3)).copy()),
                               *(T(a) for a in (o, d, lo, hi)))
    np.testing.assert_array_equal(per_ray.numpy(), ref)


def _jax_tables(ja, o, d, tm, t_min, ks, kc):
    """JAX's 2-level CULL + EXTRACT (kslots.py:117-163) on one chunk."""
    o, d, tm = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    r = o.shape[0]
    live = tm >= 0.0
    lo0 = jnp.full((r,), jnp.float32(t_min))
    hi0 = jnp.where(live, tm, -jnp.inf)
    ss, cs, c = ja.super_size, ja.num_supers, ja.num_clusters
    cand_s = jkslots._ray_slab(ja.sbmin, ja.sbmax, o, d, lo0, hi0)
    over = jnp.sum(cand_s, axis=1) > ks
    sup = jkslots._peel_k(jkslots._pack_bits(cand_s), ks, cs)
    sup_c = jnp.minimum(sup, cs - 1)
    cand = jkslots._ray_slab(ja.cbmin[sup_c].reshape(r, ks * ss, 3),
                             ja.cbmax[sup_c].reshape(r, ks * ss, 3),
                             o, d, lo0, hi0)
    cand &= jnp.broadcast_to(sup[:, :, None] < cs,
                             (r, ks, ss)).reshape(r, ks * ss)
    cid_table = (sup_c[:, :, None] * ss
                 + jnp.arange(ss)[None, None, :]).reshape(r, ks * ss)
    n_cand = jnp.sum(cand, axis=1).astype(jnp.int32)
    over = over | (n_cand > kc)
    cand = cand & ~over[:, None]
    cols = cand.shape[1]
    slot = jkslots._peel_k(jkslots._pack_bits(cand), kc, cols)
    cid = jnp.minimum(jnp.take_along_axis(cid_table,
                                          jnp.minimum(slot, cols - 1), 1),
                      c - 1)
    return {k: np.asarray(v) for k, v in
            dict(n_cand=n_cand, over=over, cid=cid, slot=slot).items()}


def test_phantom_children_tables_match_jax(rng):
    """10 clusters in supers of 4: the last super has 2 real children and 2
    phantoms, whose inverted boxes pass for every live ray. n_cand, over and
    the cid table (phantoms clamped to C - 1) are JAX's; the rays that
    overflow k_clusters only because of phantoms are counted."""
    jtris = random_soup(rng, 160, spread=1.5)
    ja = jbuild(jtris, cluster_size=16, super_size=4)
    assert (ja.num_clusters, ja.num_supers) == (10, 3)
    pa, _ = _port(ja, jtris)
    o, d = _unit_rays(rng, 256, 2.0)
    tm = rng.uniform(0.5, 6.0, 256).astype(np.float32)
    tm[::7] = -1.0
    ks, kc = 3, 3
    ref = _jax_tables(ja, o, d, tm, 1e-3, ks, kc)
    got = cuda_cull._kslots_chunk(pa, T(o), T(d), T(tm), 1e-3, ks, kc, 2)
    np.testing.assert_array_equal(got["n_cand"].numpy(), ref["n_cand"])
    np.testing.assert_array_equal(got["over"].numpy(), ref["over"])
    np.testing.assert_array_equal(got["cid"].numpy(), ref["cid"])
    n_slots = got["n_slots"].numpy()
    np.testing.assert_array_equal(n_slots, np.where(
        ref["over"], 0, (ref["slot"] < ks * 4).sum(axis=1)))
    # phantoms are real: a live ray whose supers include the last one
    # counts its two phantom children
    slab = kslots._ray_slab(pa.cbmin[2], pa.cbmax[2], T(o), T(d),
                            torch.full((256,), 1e-3), T(np.where(
                                tm >= 0, tm, -np.inf)))
    assert slab[:, 2:].all(dim=1).numpy()[tm >= 0].all()
    phantom = got["phantom_only"].numpy()
    assert phantom.any()
    assert (phantom <= ref["over"]).all()


def test_kslot_sweep_plain_matches_the_eager_resolve(rng):
    """kslot_sweep_plain against the reference's SWEEP + RESOLVE
    (kslots.py:165-185, XLA's _mt_sweep and min / min-tri reduce) on the
    port's own cull tables, closest and any hit, dead and overflowed rays
    included."""
    jtris = random_soup(rng, 600)
    ja = jbuild(jtris, cluster_size=16, super_size=4)
    pa, _ = _port(ja, jtris)
    o, d = _unit_rays(rng, 300, 6.0)
    tm = rng.uniform(0.3, 12.0, 300).astype(np.float32)
    tm[::7] = -1.0
    tab = cuda_cull._kslots_chunk(pa, T(o), T(d), T(tm), 1e-3, 6, 5, 2)
    over = tab["over"].numpy()
    assert over.any() and (~over & (tm >= 0)).any()
    tb = np.where((tm >= 0) & ~over, tm, -1.0).astype(np.float32)
    rays = cuda_kslots.pack_rays(T(o), T(d), T(tb), 1e-3)
    pack = cuda_ctiles.pack_tris(pa)
    cid, n_slots = tab["cid"], tab["n_slots"]
    t_p, tri_p = cuda_kslots.kslot_sweep_plain(pack, rays, cid, n_slots,
                                               True)
    (occ_p,) = cuda_kslots.kslot_sweep_plain(pack, rays, cid, n_slots, False)
    # the reference's resolve
    c = jnp.asarray(cid.numpy())
    r, k = cid.shape
    tt, ok = _mt_sweep(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
                       ja.v0[c].reshape(r, -1, 3), ja.e1[c].reshape(r, -1, 3),
                       ja.e2[c].reshape(r, -1, 3), 1e-3,
                       jnp.asarray(tb)[:, None])
    mask = jnp.repeat(jnp.arange(k)[None] < jnp.asarray(n_slots.numpy())[:,
                                                                          None],
                      ja.cluster_size, axis=1)
    ok = ok[:, 0] & mask
    tt = jnp.where(ok, tt[:, 0], jnp.inf)
    best = jnp.min(tt, axis=1)
    tri = jnp.min(jnp.where(ok & (tt <= best[:, None]),
                            ja.tri_id[c].reshape(r, -1), 2**31 - 1), axis=1)
    np.testing.assert_array_equal(tri_p.numpy(), np.asarray(tri))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(best), **T_TOL)
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(jnp.any(ok, 1)))
    assert occ_p.numpy().any() and not occ_p.numpy()[over].any()
