"""The worklist's cull (accel.cuda_cull.worklist_cull and its plain version)
on the CPU.

- `worklist_cull_plain`, the plain version that the CPU runs and the card's
  kernel is held against, against the JAX package's `_build_worklist`
  tables (order_g, n_cand, overflow; an item budget that spills nothing)
  at both levels: on the crafted cases of tests/test_torch_sweep_cases.py
  (wl_cull_case: a block at exactly cap and at cap + 1, supers at exactly
  super_cap and one past it, k_eff clamped by super_cap * super_size, an
  all-dead block, a NaN t_max lane, a dead lane with a NaN origin, a live
  lane with a NaN direction, axis-parallel and -0.0 directions, a last
  super of one real child and 15 padding children, C < 32, C not a
  multiple of 32, levels=1 past 2048 clusters, blocks of 1 and 64 rays),
  each at its cap and one more, and on the small scenes of
  tests/test_torch_worklist_2level.py at blocks of 8 and 64. Exact: every
  column of every row.
- the item-budget spill (item_budget=1): the port's whole tables against
  JAX's;
- each crafted case reaches its edge (on JAX's result);
- the plain version does not depend on its row chunk;
- on the CPU _build_worklist runs the plain version and launches nothing;
  the kernel's wrapper raises on CPU tensors and bad shapes before it
  builds anything;
- the exact item sweep reads no host value for its item count (the mxu
  one still does), and item_sweep_plain takes the count as a tensor.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu_torch.accel import (
    cuda_ctiles,
    cuda_cull,
    cuda_items,
    worklist,
)
from path_tracer_ai_tpu_torch.accel.traverse import pack_block_rays
from path_tracer_ai_tpu_torch.utils import sync
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import _camera_rays, _scene

G = 4  # clusters an item, the worklist's default
BOX_KEYS = ("bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(case):
    """(JAX's accel, the port's accel) of a crafted case: the box tables
    and the sizes _build_worklist reads."""
    sizes = dict(num_clusters=case["bmin"].shape[0],
                 num_supers=case["sbmin"].shape[0], super_size=case["ss"])
    ja = SimpleNamespace(**{k: jnp.asarray(case[k]) for k in BOX_KEYS},
                         **sizes)
    pa = SimpleNamespace(**{k: torch.as_tensor(case[k]) for k in BOX_KEYS},
                         **sizes)
    return ja, pa


def _k_eff(acc, cap, levels, super_cap):
    k = min(cap, acc.num_clusters)
    if levels == 2:
        k = min(k, min(super_cap, acc.num_supers) * acc.super_size)
    return k


def _jax_cull(ja, o, d, tm, cap, levels, super_cap):
    """JAX's cull outputs, read off _build_worklist with an item budget
    that spills nothing: (order [nb, width], n_cand, overflow)."""
    nb = o.shape[0]
    n_groups = -(-_k_eff(ja, cap, levels, super_cap) // G)
    wl = jworklist._build_worklist(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 1e-3, cap, G,
        n_groups + 1, nb, 1, levels=levels, super_cap=super_cap)
    return (np.asarray(wl.order_g).reshape(nb, -1), np.asarray(wl.n_cand),
            np.asarray(wl.overflow))


def _plain(pa, o, d, tm, cap, levels, super_cap, **kw):
    k_eff = _k_eff(pa, cap, levels, super_cap)
    t = torch.as_tensor
    return cuda_cull.worklist_cull_plain(
        pa, t(o), t(d), t(tm), cap, k_eff, -(-k_eff // G) * G, levels,
        super_cap, **kw)


def _assert_equal(got, want):
    order, n_cand, over = got
    assert order.dtype == torch.int32 and n_cand.dtype == torch.int32
    assert over.dtype == torch.bool
    np.testing.assert_array_equal(n_cand.numpy(), want[1])
    np.testing.assert_array_equal(over.numpy(), want[2])
    np.testing.assert_array_equal(order.numpy(), want[0])


def _variants(name, case):
    """(cap, super_cap) the case is held at: its own and, where the case is
    about a cap, that cap + 1."""
    cap, scap = case["cap"], case["super_cap"]
    return [(cap, scap)] + {"cap_edge": [(cap + 1, scap)],
                            "super_edge": [(cap, scap + 1)]}.get(name, [])


CASE_LEVELS = [(name, levels) for name in cases.WL_CULL_CASES
               for levels in cases.wl_cull_case(name)["levels"]]


@functools.lru_cache(maxsize=None)
def _jax_case(name, levels, cap, super_cap):
    """JAX's cull of a crafted case (each computed once a process)."""
    case = cases.wl_cull_case(name)
    ja, _pa = _accels(case)
    return _jax_cull(ja, case["o"], case["d"], case["tm"], cap, levels,
                     super_cap)


@pytest.mark.parametrize("name,levels", CASE_LEVELS)
def test_plain_matches_jax_on_crafted_cases(name, levels):
    case = cases.wl_cull_case(name)
    _ja, pa = _accels(case)
    args = (case["o"], case["d"], case["tm"])
    for cap, super_cap in _variants(name, case):
        _assert_equal(_plain(pa, *args, cap, levels, super_cap),
                      _jax_case(name, levels, cap, super_cap))


def _reach(name, levels=2, **kw):
    case = cases.wl_cull_case(name)
    p = dict(cap=case["cap"], super_cap=case["super_cap"])
    p.update(kw)
    return case, _jax_case(name, levels, p["cap"], p["super_cap"])


def test_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    for levels in (1, 2):
        case, (_o, n, over) = _reach("cap_edge", levels)
        assert (n == case["cap"]).any() and over.any()
        _c, (_o, n1, over1) = _reach("cap_edge", levels, cap=case["cap"] + 1)
        assert (n1[over] == case["cap"] + 1).all() and not over1.any()
    case, (order, n, over) = _reach("super_edge")
    k_eff = case["super_cap"] * case["ss"]
    assert k_eff < min(case["cap"], case["bmin"].shape[0])
    assert order.shape[1] == k_eff and (n == k_eff).any() and over.any()
    _c, (_o, n1, over1) = _reach("super_edge",
                                 super_cap=case["super_cap"] + 1)
    assert (n1[over] == (case["super_cap"] + 1) * case["ss"]).all()
    assert not over1.any()
    case, (_o, n, over) = _reach("dead_and_nan")
    assert (n[:5] == 0).tolist() == [True, True, False, True, True]
    assert not over.any() and np.isnan(case["tm"][1]).any()
    assert np.isnan(case["o"][2]).any() and np.isnan(case["d"][3]).any()
    case, (_o, n, _v) = _reach("axis_signed_zero")
    zero, neg = case["d"] == 0, np.signbit(case["d"])
    assert (~zero | neg).all(axis=(1, 2)).any()  # blocks of -0.0 only
    assert ((zero & neg).any(axis=1) & (zero & ~neg).any(axis=1)).any()
    assert (n > 0).any()
    case, (order, n2, _v) = _reach("phantoms")
    _c, (_o, n1, _v) = _reach("phantoms", levels=1)
    c = case["bmin"].shape[0]
    assert c % case["ss"] == 1 and ((n2 - n1) == case["ss"] - 1).any()
    assert (order[n2 - n1 == case["ss"] - 1, :case["ss"]] == c - 1).all()
    for name, want in (("small_c", lambda c: c < 32),
                       ("cap_edge", lambda c: c % 32 != 0),
                       ("flat_past_2048", lambda c: c > 2048)):
        case, (_o, n, over) = _reach(name, levels=1)
        assert want(case["bmin"].shape[0]) and (n > 0).any()
    for name, b in (("block_1", 1), ("block_64", 64)):
        case, (_o, n, _v) = _reach(name)
        assert case["o"].shape[1] == b and (n > 0).any()


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("levels", [1, 2])
def test_plain_matches_jax_on_scenes(rng, levels, block):
    """The 2-level tests' soup (500 triangles in clusters of 12, supers of
    4: the last super holds two padding children) and its camera rays,
    sorted into blocks as the worklist sorts them."""
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _camera_rays(rng, 1024)
    ob, db, tb, _, _ = jworklist._prepare_blocks(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), block, True)
    args = tuple(np.array(x) for x in (ob, db, tb))
    for cap, super_cap in ((64, pa.num_supers), (16, 8)):
        want = _jax_cull(ja, *args, cap, levels, super_cap)
        got = _plain(pa, *args, cap, levels, super_cap)
        _assert_equal(got, want)
        assert (got[1] > 0).any()


@pytest.mark.parametrize("levels", [1, 2])
def test_item_budget_spill_tables_equal_jax(rng, levels):
    """item_budget=1: blocks spill past the item budget; the port's whole
    tables (n_items, ibase, item_block, order_g, n_cand, overflow) are
    JAX's."""
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _camera_rays(rng, 512)
    ob, db, tb, _, _ = jworklist._prepare_blocks(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 8, True)
    kw = dict(levels=levels, super_cap=pa.num_supers)
    wj = jworklist._build_worklist(ja, ob, db, tb, 1e-3, 64, G, 1, 64, 8,
                                   **kw)
    wt = worklist._build_worklist(
        pa, *(torch.as_tensor(np.array(x)) for x in (ob, db, tb)), 1e-3,
        64, G, 1, 64, 8, **kw)
    n_items = int(wj.n_items)
    assert int(wt.n_items) == n_items > 0
    assert bool(np.asarray(wj.overflow).any())
    for name in ("ibase", "order_g", "n_cand", "overflow"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      np.asarray(getattr(wj, name)), name)
    np.testing.assert_array_equal(wt.item_block.numpy()[:n_items],
                                  np.asarray(wj.item_block)[:n_items])


@pytest.mark.parametrize("row_chunk", [1, 5, 8192])
@pytest.mark.parametrize("levels", [1, 2])
def test_plain_row_chunks_agree(levels, row_chunk):
    case = cases.wl_cull_case("axis_signed_zero")
    _ja, pa = _accels(case)
    args = (case["o"], case["d"], case["tm"], 48, levels, 8)
    ref = _plain(pa, *args, row_chunk=3)
    got = _plain(pa, *args, row_chunk=row_chunk)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_build_worklist_runs_the_plain_version_on_cpu(monkeypatch):
    case = cases.wl_cull_case("cap_edge")
    _ja, pa = _accels(case)
    calls = []

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    real = cuda_cull.worklist_cull_plain

    def spy(*a, **k):
        calls.append(a[7])  # levels
        return real(*a, **k)

    monkeypatch.setattr(cuda_cull, "worklist_cull", no_kernel)
    monkeypatch.setattr(cuda_cull, "worklist_cull_plain", spy)
    cuda_cull.reset_launches()
    t = torch.as_tensor
    for levels in (1, 2):
        wl = worklist._build_worklist(pa, t(case["o"]), t(case["d"]),
                                      t(case["tm"]), 1e-3, 6, G, 6, 64, 8,
                                      levels=levels)
        assert wl.order_g.shape == (16, 2, G)
    assert calls == [1, 2] and cuda_cull.worklist_launches == 0


def _wrapper_inputs(**change):
    case = cases.wl_cull_case("cap_edge")
    _ja, pa = _accels(case)
    args = {"o_blk": torch.as_tensor(case["o"]),
            "d_blk": torch.as_tensor(case["d"]),
            "tm_blk": torch.as_tensor(case["tm"])}
    args.update(change)
    return pa, args


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("bad,exc,match", [
    ({}, ValueError, "CUDA kernel"),
    ({"o_blk": torch.zeros((16, 8, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"tm_blk": torch.zeros((16, 8), dtype=torch.int32)}, TypeError,
     "float32"),
    ({"d_blk": torch.zeros((16, 3, 8)).transpose(1, 2)}, ValueError,
     "contiguous"),
    ({"tm_blk": torch.zeros((16, 16))[:, ::2]}, ValueError, "contiguous"),
    ({"o_blk": torch.zeros((16, 8))}, ValueError, "dims"),
])
def test_wrapper_raises(monkeypatch, levels, bad, exc, match):
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    pa, args = _wrapper_inputs(**bad)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        cuda_cull.worklist_cull(pa, args["o_blk"], args["d_blk"],
                                args["tm_blk"], 6, 6, 8, levels)
    assert cuda_cull.worklist_launches == 0


@pytest.mark.parametrize("change,match", [
    (dict(levels=3), "levels 1 or 2"),
    (dict(k_eff=9), "k_eff"),
    (dict(boxes=("cbmin", torch.zeros((18, 4, 3), dtype=torch.float64))),
     "cbmin"),
    (dict(boxes=("sbmin", torch.zeros((18, 3))[:, :2])), "shape|contiguous"),
])
def test_wrapper_raises_on_sizes_and_boxes(change, match):
    """Bad levels, k_eff past the row and box tables of the wrong type or
    shape raise before any launch (the 2-level tables are checked too)."""
    pa, args = _wrapper_inputs()
    if "boxes" in change:
        name, x = change["boxes"]
        setattr(pa, name, x)
    with pytest.raises((ValueError, TypeError), match=match):
        cuda_cull.worklist_cull(pa, args["o_blk"], args["d_blk"],
                                args["tm_blk"], 6, change.get("k_eff", 6), 8,
                                change.get("levels", 2))


@pytest.mark.parametrize("intersector,reads", [("exact", 0), ("mxu", 1)])
def test_sweep_items_reads_the_count_on_the_device(rng, intersector, reads):
    """The exact item sweep takes the WorkList's n_items tensor as it is
    (no host read); the mxu sweep loops on the host and reads it once."""
    ja, pa, _ = _scene(rng, 300, 8, super_size=4)
    o, d, tm = _camera_rays(rng, 256)
    blocks = worklist._prepare_blocks(pa, torch.as_tensor(o),
                                      torch.as_tensor(d), torch.as_tensor(tm),
                                      8, True)[:3]
    wl = worklist._build_worklist(pa, *blocks, 1e-3, 64, G, 6, 64, 16)
    rays = pack_block_rays(*blocks, 1e-3)
    seen = []
    real = cuda_items.item_sweep

    def spy(*a):
        seen.append(a[6])
        return real(*a)

    sync.reset()
    try:
        cuda_items.item_sweep = spy
        res = worklist._sweep_items(pa, wl, rays, True, intersector)
    finally:
        cuda_items.item_sweep = real
    assert sync.count == reads
    if intersector == "exact":
        assert len(seen) == 1 and seen[0] is wl.n_items
        want = cuda_items.item_sweep_plain(
            cuda_ctiles.pack_tris(pa), rays, wl.item_block, wl.ibase,
            wl.order_g, wl.n_cand, int(wl.n_items), True)
        assert all(torch.equal(a, b) for a, b in zip(res, want))
        assert (res[1] != cuda_ctiles.I32_MAX).any()
