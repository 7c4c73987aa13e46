"""The port's 2-level worklist cull, its WorkList tables and its item sweep
against the JAX package's (the flat cull and the fallback routes are in
tests/test_torch_worklist.py, with the tolerances stated there).

The 2-level cull is forced with levels=2 and super_cap = the super count on
soups of 300-600 triangles in clusters of 8-16 and supers of 4. The tables
must equal JAX's on every live slot; item_sweep's plain version must equal
JAX's `_sweep_items` item row for item row.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_items, worklist
from path_tracer_ai_tpu_torch.accel.traverse import pack_block_rays
from tests.test_torch_worklist import (  # noqa: F401
    CASES,
    LEVELS,
    T,
    T_TOL,
    _camera_rays,
    _check,
    _levels_kw,
    _one_torch_thread,
    _rays,
    _scene,
)


@pytest.mark.parametrize("case", sorted(CASES))
def test_worklist_2level_matches_jax(rng, case):
    n_tris, s, n, kw = CASES[case]
    ja, pa, ptris = _scene(rng, n_tris, s, super_size=4)
    o, d, tm = _rays(rng, n)
    _check(ja, pa, ptris, o, d, tm, **kw, **_levels_kw("2level", ja))


def _blocks(pa, ja, o, d, tm, block=8, sort=True):
    """The sorted blocks of both sides (the port's _prepare_blocks must
    equal JAX's bitwise)."""
    ob, db, tb, _, _ = jworklist._prepare_blocks(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), block, sort)
    pb = worklist._prepare_blocks(pa, T(o), T(d), T(tm), block, sort)
    for a, b in zip(pb[:3], (ob, db, tb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return (ob, db, tb), pb[:3]


def _tables(ja, pa, jb, pb, **kw):
    kw = dict(dict(cap=64, group=4, item_budget=6, row_chunk=64,
                   item_align=16), **kw)
    wj = jworklist._build_worklist(ja, *jb, 1e-3, **kw)
    wt = worklist._build_worklist(pa, *pb, 1e-3, **kw)
    return wj, wt


def _assert_tables_equal(wj, wt, k_eff, g=4):
    n_items = int(wj.n_items)
    assert int(wt.n_items) == n_items > 0
    for name in ("ibase", "n_cand", "overflow"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      np.asarray(getattr(wj, name)), name)
    assert wt.item_block.shape == wj.item_block.shape
    np.testing.assert_array_equal(wt.item_block.numpy()[:n_items],
                                  np.asarray(wj.item_block)[:n_items])
    og_t, og_j = wt.order_g.numpy(), np.asarray(wj.order_g)
    assert og_t.shape == og_j.shape
    nb, n_groups = og_j.shape[:2]
    slot = np.arange(n_groups * g).reshape(n_groups, g)
    live = slot[None] < np.asarray(wj.n_cand)[:, None, None]
    np.testing.assert_array_equal(og_t[live], og_j[live])
    # the extracted ids of a block ascend (the reference's top_k order);
    # slots past k_eff hold order_g's zero padding
    for row, n in zip(og_t.reshape(nb, -1), np.asarray(wj.n_cand)):
        assert (np.diff(row[:min(n, k_eff)]) >= 0).all()


def _k_eff(pa, cap=64, levels=1, super_cap=32):
    k = min(cap, pa.num_clusters)
    if levels == 2:
        k = min(k, min(super_cap, pa.num_supers) * pa.super_size)
    return k


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("kw", [{}, dict(cap=10), dict(item_budget=1)])
def test_build_worklist_tables_equal_jax(rng, levels, kw):
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _camera_rays(rng, 512)
    jb, pb = _blocks(pa, ja, o, d, tm)
    lkw = _levels_kw(levels, ja)
    wj, wt = _tables(ja, pa, jb, pb, **kw, **lkw)
    _assert_tables_equal(wj, wt, _k_eff(pa, **kw_only(kw, "cap"), **lkw))
    assert bool(wt.overflow.any()) == bool(kw)


def kw_only(kw, *names):
    return {k: v for k, v in kw.items() if k in names}


def test_2level_phantom_padding_children(rng):
    """500 triangles / 12 = 42 clusters in supers of 4: the last super holds
    2 clusters and 2 padding children with inverted boxes. The reference's
    interval slab does not fail an inverted box (each axis bound becomes
    (-huge, +huge)), so where the last super is a candidate its padding
    children count too: the 2-level n_cand exceeds the flat one by up to 2.
    The port keeps those tables bit for bit; a phantom's id lands on a real
    cluster (clamped to C - 1, or the zero padding of order_g past k_eff),
    a repeat that changes no result."""
    ja, pa, ptris = _scene(rng, 500, 12, super_size=4)
    n_pad = pa.num_supers * pa.super_size - pa.num_clusters
    assert n_pad == 2
    assert bool((pa.cbmin[-1, -n_pad:] > pa.cbmax[-1, -n_pad:]).all())
    o, d, tm = _camera_rays(rng, 512)
    jb, pb = _blocks(pa, ja, o, d, tm)
    kw = dict(levels=2, super_cap=pa.num_supers)
    wj, wt = _tables(ja, pa, jb, pb, **kw)
    _assert_tables_equal(wj, wt, _k_eff(pa, **kw))
    _, flat = _tables(ja, pa, jb, pb, levels=1)
    extra = (wt.n_cand - flat.n_cand).numpy()
    assert (extra >= 0).all() and (extra <= n_pad).all()
    assert (extra == n_pad).any()
    _check(ja, pa, ptris, o, d, tm, **kw)


@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_item_sweep_plain_matches_jax_sweep_items(rng, want_tri, levels):
    """item_sweep_plain on the port's tables equals JAX's _sweep_items on
    JAX's: every item row (t within T_TOL, tri and occlusion exact, rows
    past n_items inf / INT32_MAX / False)."""
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _camera_rays(rng, 512)
    if not want_tri:
        tm = np.where(tm > 0, rng.uniform(4.0, 14.0, tm.shape[0]),
                      tm).astype(np.float32)
    jb, pb = _blocks(pa, ja, o, d, tm)
    wj, wt = _tables(ja, pa, jb, pb, **_levels_kw(levels, ja))
    res_j = jworklist._sweep_items(ja, wj, *jb, 1e-3, 4, 16, want_tri)
    assert int(wt.n_items) > 100
    res_t = cuda_items.item_sweep(
        cuda_ctiles.pack_tris(pa), pack_block_rays(*pb, 1e-3), wt.item_block,
        wt.ibase, wt.order_g, wt.n_cand, int(wt.n_items), want_tri)
    if want_tri:
        np.testing.assert_array_equal(res_t[1].numpy(), np.asarray(res_j[1]))
        np.testing.assert_allclose(res_t[0].numpy(), np.asarray(res_j[0]),
                                   **T_TOL)
        assert (res_t[1].numpy() != cuda_ctiles.I32_MAX).any()
    else:
        np.testing.assert_array_equal(res_t[0].numpy(), np.asarray(res_j[0]))
        assert res_t[0].numpy().any()
