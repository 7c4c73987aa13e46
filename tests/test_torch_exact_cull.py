"""The port's exact shadow cull (traverse._exact_block_candidates) and the
packet cascade that takes it, against the JAX package's and brute force.

Same inputs (numpy, seeded) through both packages on the CPU. The cull's
tables must equal JAX's bit for bit: n_cand and entry_sorted whole, order
on the live slots (slots past n_cand are padding either way), for blocks
within the super shortlist, blocks past it (the conservative list), the
live-prefix form of a wave sorted dead-last, and a scene whose last
super holds inverted padding children. Occlusion is exact under any
candidate superset, so the cascades must equal brute force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup

T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(rng, n_tris, s, super_size=4, spread=4.0):
    jtris = random_soup(rng, n_tris, spread=spread)
    ja = jbuild(jtris, cluster_size=s, super_size=super_size)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris),
                                 device="cpu")
    return ja, pa, ptris


def _waves(rng, n=512, b=64, dead_tail=None):
    """tests/test_accel.py's exact-cull waves: random rays, every fifth
    lane dead, or (dead_tail) every lane from that index on."""
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 20.0, n).astype(np.float32)
    if dead_tail is None:
        tm[::5] = -1.0
    else:
        tm[dead_tail:] = -1.0
    return o.reshape(-1, b, 3), d.reshape(-1, b, 3), tm.reshape(-1, b)


def _both(ja, pa, o_blk, d_blk, tm_blk, ksup, live=False):
    lv_j = lv_t = None
    if live:
        lv_j = jnp.sum(jnp.any(jnp.asarray(tm_blk) >= 0.0, axis=1)).astype(
            jnp.int32)
        lv_t = traverse.live_block_count(T(tm_blk))
        assert lv_t == int(lv_j)
    got_j = jtraverse._exact_block_candidates(
        ja, jnp.asarray(o_blk), jnp.asarray(d_blk), jnp.asarray(tm_blk),
        1e-3, ksup=ksup, row_chunk=2, live_blocks=lv_j)
    got_t = traverse._exact_block_candidates(
        pa, T(o_blk), T(d_blk), T(tm_blk), 1e-3, ksup=ksup,
        live_blocks=lv_t)
    return [np.asarray(a) for a in got_j], [a.numpy() for a in got_t]


def _assert_tables_equal(got_j, got_t):
    (order_j, n_j, entry_j), (order_t, n_t, entry_t) = got_j, got_t
    assert order_t.dtype == np.int32 and n_t.dtype == np.int32
    np.testing.assert_array_equal(n_t, n_j)
    np.testing.assert_array_equal(entry_t.view(np.int32),
                                  entry_j.view(np.int32))
    assert order_t.shape == order_j.shape
    live = np.arange(order_j.shape[1])[None, :] < n_j[:, None]
    np.testing.assert_array_equal(order_t[live], order_j[live])


# (soup triangles, cluster size, ksup, wave options, live-prefix form)
CASES = {
    # 63 clusters in supers of 4: the last super has an inverted padding
    # child, and the shortlist holds every super
    "all_supers_padding_child": (500, 8, None, {}, False),
    "shortlist_4": (500, 8, 4, {}, False),
    # ksup 1: most blocks overflow to the conservative list
    "overflow_ksup_1": (600, 8, 1, {}, False),
    # the dead-last form: live blocks are a prefix, the rest stay empty
    "live_prefix": (500, 8, 4, dict(dead_tail=200), True),
    "clusters_of_16": (600, 16, 16, {}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_block_candidates_match_jax(rng, case):
    n_tris, s, ksup, wkw, live = CASES[case]
    ja, pa, _ = _scene(rng, n_tris, s, spread=2.0 if ksup == 1 else 4.0)
    if case == "all_supers_padding_child":
        n_pad = pa.num_supers * pa.super_size - pa.num_clusters
        assert n_pad > 0
        assert bool((pa.cbmin[-1, -n_pad:] > pa.cbmax[-1, -n_pad:]).all())
    ksup = pa.num_supers if ksup is None else ksup
    got_j, got_t = _both(ja, pa, *_waves(rng, **wkw), ksup=ksup, live=live)
    _assert_tables_equal(got_j, got_t)
    assert got_t[1].max() > 0


def test_overflow_blocks_take_the_conservative_list(rng):
    """ksup 1: a block whose super union passes the shortlist holds the
    conservative list, order, n_cand and entries, as in the reference."""
    _ja, pa, _ = _scene(rng, 600, 8, spread=2.0)
    blk = _waves(rng)
    _order, n_t, _entry = traverse._exact_block_candidates(
        pa, *(T(a) for a in blk), 1e-3, ksup=1)
    order_c, n_c, entry_c = traverse._block_candidates(pa,
                                                       *(T(a) for a in blk))
    over = 0
    for i in range(n_t.shape[0]):
        if int(n_t[i]) == int(n_c[i]) and int(n_c[i]) > 0:
            over += 1
            assert torch.equal(_order[i, :n_c[i]], order_c[i, :n_c[i]])
            assert torch.equal(_entry[i], entry_c[i])
    assert over > 0


def test_exact_cull_is_tighter_and_covers_every_hit(rng):
    """The exact list is a subset of the conservative one, and holds the
    cluster of every triangle a live lane hits (brute force)."""
    _ja, pa, ptris = _scene(rng, 600, 8)
    o_blk, d_blk, tm_blk = (T(a) for a in _waves(rng))
    order, n_cand, _ = traverse._exact_block_candidates(
        pa, o_blk, d_blk, tm_blk, 1e-3, ksup=pa.num_supers)
    order_c, n_c, _ = traverse._block_candidates(pa, o_blk, d_blk, tm_blk)
    assert int(n_cand.sum()) < int(n_c.sum())
    tri_cluster = {int(t): c for c in range(pa.num_clusters)
                   for t in pa.tri_id[c].tolist() if t >= 0}
    nb, b = tm_blk.shape
    hit = intersect.closest_hit(ptris, o_blk.reshape(-1, 3),
                                d_blk.reshape(-1, 3), 1e-3,
                                tm_blk.reshape(-1))
    for i in range(nb):
        listed = set(order[i, :n_cand[i]].tolist())
        assert listed <= set(order_c[i, :n_c[i]].tolist())
        for lane in range(b):
            j = i * b + lane
            if bool(hit.hit[j]):
                assert tri_cluster[int(hit.tri[j])] in listed


@pytest.mark.parametrize("kw", [
    dict(exact_cull=16), dict(exact_cull=1),
    dict(exact_cull=16, sort=False, group_size=2, block_size=64),
])
def test_any_hit_packets_exact_cull_matches_brute_force(rng, kw):
    """tests/test_accel.py::test_anyhit_packets_exact_cull on the port: the
    cascade with the exact cull equals brute force, the conservative-cull
    cascade and JAX's."""
    jtris = random_soup(rng, 600)
    ja = jbuild(jtris, cluster_size=16, super_size=4)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris),
                                 device="cpu")
    o = rng.uniform(-6.0, 6.0, (512, 3)).astype(np.float32)
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 15.0, 512).astype(np.float32)
    tm[::5] = -1.0
    args = (T(o), T(d), 1e-3, T(tm))
    occ = traverse.any_hit_packets(pa, *args, **kw).numpy()
    np.testing.assert_array_equal(occ, intersect.any_hit(ptris, *args).numpy())
    base = {k: v for k, v in kw.items() if k != "exact_cull"}
    np.testing.assert_array_equal(
        occ, traverse.any_hit_packets(pa, *args, **base).numpy())
    occ_j = jtraverse.any_hit_packets(ja, jnp.asarray(o), jnp.asarray(d),
                                      1e-3, jnp.asarray(tm), **kw)
    np.testing.assert_array_equal(occ, np.asarray(occ_j))
    assert occ.any() and not occ.all()


def test_exact_cull_step_does_not_change_the_tables(rng, monkeypatch):
    """The per-lane stages run EXACT_CULL_ELEMS elements a step; a step of
    a few blocks gives the same tables."""
    _ja, pa, _ = _scene(rng, 500, 8)
    blk = [T(a) for a in _waves(rng)]
    ref = traverse._exact_block_candidates(pa, *blk, 1e-3, ksup=4)
    monkeypatch.setattr(cuda_cull, "EXACT_CULL_ELEMS", 64 * 16 * 3)
    got = traverse._exact_block_candidates(pa, *blk, 1e-3, ksup=4)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
