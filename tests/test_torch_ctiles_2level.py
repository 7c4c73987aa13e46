"""ctiles' 2-level cull (accel.cuda_ctiles.block_cull at levels 2 and its
plain version) on the CPU.

- `block_cull_plain(..., levels=2)`, the plain version that the CPU runs
  and the card's kernel is held against, against the JAX package's
  `_block_candidates_2level` (path_tracer_ai_tpu/accel/ctiles.py): order,
  n_cand and over, every slot of every row, on the crafted cases of
  tests/test_torch_sweep_cases.py (ctiles2_case: dead, -0.0, +0.0, NaN and
  +inf t_max; origins on slab planes of axis-parallel rays; +-0.0
  direction components; flat boxes; exactly cap children and cap + 1;
  exactly super_cap supers and one more; a last super of one real child
  and 15 padding children, which fail; C < 32) in blocks of 8 and 4, at
  cap and super_cap and one past each, with and without a live-block
  count; and on a small random accel;
- past the live-block count every row holds the empty set (order C - 1,
  n_cand 0, over False), also where the rays there are live, as the
  kernel's rows do; before it the rows are JAX's;
- each crafted case reaches its edge (on JAX's result);
- the plain version does not depend on its row chunk;
- closest_hit_ctiles / any_hit_ctiles at levels 2 run the plain version
  on the CPU, through block_cull_plain, and read no host value at a site
  of accel.ctiles; block_cull raises on a bad levels or device.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import ctiles as jctiles
from path_tracer_ai_tpu_torch.accel import ctiles, cuda_ctiles, worklist
from path_tracer_ai_tpu_torch.utils import sync
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import T, _rays, _scene

BOX_KEYS = ("bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")
ROW_CHUNK = 3  # the plain version's row chunk on the crafted cases
JAX_ROW_CHUNK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(case):
    sizes = dict(num_clusters=case["bmin"].shape[0],
                 num_supers=case["sbmin"].shape[0], super_size=case["ss"])
    ja = SimpleNamespace(**{k: jnp.asarray(case[k]) for k in BOX_KEYS},
                         **sizes)
    pa = SimpleNamespace(**{k: torch.as_tensor(case[k]) for k in BOX_KEYS},
                         **sizes)
    return ja, pa


def _variants(case):
    """(cap, super_cap) a case is held at: its own, one past each, and the
    ray_cull_case's kc / ks."""
    cap, scap = case["cap"], case["super_cap"]
    out = [(cap, scap), (cap + 1, scap), (cap, scap + 1)]
    return out + [(case["kc"], case["ks"])] * ((case["kc"], case["ks"])
                                               not in out)


@functools.lru_cache(maxsize=None)
def _jax_case(name, b, cap, scap, live):
    case = cases.ctiles2_case(name, b)
    ja, _pa = _accels(case)
    out = jctiles._block_candidates_2level(
        ja, jnp.asarray(case["o_blk"]), jnp.asarray(case["d_blk"]),
        jnp.asarray(case["tm_blk"]), case["t_min"], cap, JAX_ROW_CHUNK, scap,
        live_blocks=live)
    return tuple(np.asarray(x) for x in out)


def _plain(pa, case, cap, scap, live=None, row_chunk=ROW_CHUNK, tm=None):
    t = torch.as_tensor
    return cuda_ctiles.block_cull_plain(
        pa, t(case["o_blk"]), t(case["d_blk"]),
        t(case["tm_blk"] if tm is None else tm), case["t_min"], cap, live,
        row_chunk=row_chunk, levels=2, super_cap=scap)


def _assert_rows(got, want, rows):
    for g, w, key in zip(got, want, ("order", "n_cand", "over")):
        np.testing.assert_array_equal(g.numpy()[:rows], w[:rows], key)


def _assert_empty_past(got, lb, c):
    order, n_cand, over = (x.numpy() for x in got)
    assert (order[lb:] == c - 1).all()
    assert (n_cand[lb:] == 0).all() and not over[lb:].any()


@pytest.mark.parametrize("b", cases.CTILES2_BLOCKS)
@pytest.mark.parametrize("name", cases.CTILES2_CASES)
def test_plain_matches_jax_on_crafted_cases(name, b):
    case = cases.ctiles2_case(name, b)
    _ja, pa = _accels(case)
    nb = case["o_blk"].shape[0]
    c = pa.num_clusters
    for cap, scap in _variants(case):
        got = _plain(pa, case, cap, scap)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        assert got[2].dtype == torch.bool
        _assert_rows(got, _jax_case(name, b, cap, scap, None), nb)
    # a live-block count: the rows before it are JAX's, the rows past it
    # the empty set, whatever their rays (a dead tail, as a sorted wave's;
    # a live one)
    cap, scap = case["cap"], case["super_cap"]
    lb = nb // 2 + 1
    tm = case["tm_blk"].copy()
    tm[lb:] = -1.0
    want = _jax_case(name, b, cap, scap, lb)
    for tail in (tm, case["tm_blk"]):
        got = _plain(pa, case, cap, scap, live=lb, tm=tail)
        _assert_rows(got, want, lb)
        _assert_empty_past(got, lb, c)
    got = _plain(pa, case, cap, scap, live=0)
    _assert_empty_past(got, 0, c)


def test_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    # count_edges in blocks of 8: a block at exactly cap and super_cap, one
    # past cap (its two supers listed), one past super_cap
    case = cases.ctiles2_case("count_edges", 8)
    cap, scap = case["cap"], case["super_cap"]
    order, n, over = _jax_case("count_edges", 8, cap, scap, None)
    assert ((n == cap) & ~over).any()
    wide = _jax_case("count_edges", 8, cap + 1, scap, None)
    assert ((wide[1] == cap + 1) & over).any()       # cap + 1 overflows
    supers = _jax_case("count_edges", 8, 64, scap + 1, None)
    assert ((supers[1] == 9) & over).any()           # super_cap + 1
    assert not supers[2][supers[1] == 9].any()
    # phantoms: the last super (cluster 48 and 15 padding children) listed;
    # its padding children fail, so n_cand counts real clusters only
    case = cases.ctiles2_case("phantoms", 8)
    order, n, over = _jax_case("phantoms", 8, case["cap"], case["super_cap"],
                               None)
    with48 = (order == 48).any(axis=1) & (n > 0)
    assert with48.any() and (n[with48] <= 5).all()
    assert case["cbmin"].shape == (4, 16, 3) and case["bmin"].shape[0] == 49
    # t_max_values: a block of NaN and dead rays only has no candidate
    case = cases.ctiles2_case("t_max_values", 4)
    tm = case["tm_blk"]
    order, n, over = _jax_case("t_max_values", 4, case["cap"],
                               case["super_cap"], None)
    assert (n > 0).any()
    dead = ~(tm >= 0).any(axis=1)
    assert (n[dead] == 0).all()
    assert np.isnan(tm).any() and (np.signbit(tm) & (tm == 0)).any()
    # axis_on_plane / signed_zero / flat_boxes: candidates on those edges
    for name in ("axis_on_plane", "signed_zero", "flat_boxes"):
        case = cases.ctiles2_case(name, 8)
        assert (_jax_case(name, 8, case["cap"], case["super_cap"],
                          None)[1] > 0).any()
    # small_c: C < 32, C not a multiple of the super size
    case = cases.ctiles2_case("small_c", 8)
    assert case["bmin"].shape[0] < 32
    # the live-block count falls inside a JAX row chunk and past it
    assert (16 // 2 + 1) % JAX_ROW_CHUNK and (32 // 2 + 1) % JAX_ROW_CHUNK


@pytest.mark.parametrize("super_cap,cap", [(4, 32), (16, 16), (16, 64)])
def test_plain_matches_jax_on_a_random_accel(rng, super_cap, cap):
    """A small soup in clusters of 16 and supers of 4 (its last super
    partly filled), sorted blocks of 8, with and without a live-block
    count (rays past it dead, as a sorted wave's)."""
    ja, pa, _ = _scene(rng, 600, 16, super_size=4)
    o, d, tm = _rays(rng, 256)
    tm[200:] = -1.0
    blk = worklist._prepare_blocks(pa, T(o), T(d), T(tm), 8, True, "octorig")
    nb = blk[0].shape[0]
    lb = -(-200 // 8)
    for live in (None, lb):
        want = jctiles._block_candidates_2level(
            ja, *(jnp.asarray(x.numpy()) for x in blk[:3]), 1e-3, cap, 4,
            super_cap, live_blocks=live)
        got = cuda_ctiles.block_cull_plain(pa, *blk[:3], 1e-3, cap, live,
                                           row_chunk=4, levels=2,
                                           super_cap=super_cap)
        _assert_rows(got, [np.asarray(x) for x in want],
                     nb if live is None else lb)
        if live is not None:
            _assert_empty_past(got, lb, pa.num_clusters)
        assert bool((got[1] > 0).any() or got[2].any())


@pytest.mark.parametrize("row_chunk", [1, 5, 1 << 11])
def test_plain_row_chunks_agree(row_chunk):
    for name in ("count_edges", "phantoms", "t_max_values"):
        case = cases.ctiles2_case(name, 4)
        _ja, pa = _accels(case)
        for live in (None, 9):
            ref = _plain(pa, case, case["cap"], case["super_cap"], live)
            got = _plain(pa, case, case["cap"], case["super_cap"], live,
                         row_chunk=row_chunk)
            assert all(torch.equal(a, b) for a, b in zip(ref, got)), name


def test_queries_run_the_plain_version_on_cpu(monkeypatch):
    """closest_hit_ctiles and any_hit_ctiles at levels 2 cull through
    block_cull_plain on the CPU (the kernel's wrapper is not called) and
    read no host value at a site of accel.ctiles; the results are brute
    force's."""
    from path_tracer_ai_tpu_torch.engine import intersect

    rng = np.random.default_rng(5)
    _ja, pa, tris = _scene(rng, 600, 16, super_size=4)
    o, d, tm = _rays(rng, 256)
    calls = []
    real = cuda_ctiles.block_cull_plain

    def spy(*a, **k):
        calls.append(k.get("levels"))
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(cuda_ctiles, "block_cull_plain", spy)
    monkeypatch.setattr(cuda_ctiles, "block_cull", no_kernel)
    sync.reset()
    args = (pa, T(o), T(d), 1e-3, T(tm))
    kw = dict(levels=2, super_cap=4, cap=16, tile_chunk=4)
    h = ctiles.closest_hit_ctiles(*args, **kw)
    occ = ctiles.any_hit_ctiles(*args, **kw)
    assert calls == [2, 2]
    assert not [s for s in sync.sites
                if s.startswith("path_tracer_ai_tpu_torch.accel.ctiles:")]
    bf = intersect.closest_hit(tris, *args[1:])
    np.testing.assert_array_equal(h.t.numpy(), bf.t.numpy())
    np.testing.assert_array_equal(occ.numpy(),
                                  intersect.any_hit(tris, *args[1:]).numpy())


@pytest.mark.parametrize("levels,device,match", [
    (3, "cpu", "levels 1 or 2"),
    (0, "cpu", "levels 1 or 2"),
    (2, "meta", "cuda or cpu"),
])
def test_block_cull_raises(levels, device, match):
    case = cases.ctiles2_case("count_edges", 8)
    _ja, pa = _accels(case)
    blk = [torch.as_tensor(case[k], device=device)
           for k in ("o_blk", "d_blk", "tm_blk")]
    with pytest.raises(ValueError, match=match):
        cuda_ctiles.block_cull(pa, *blk, 1e-3, 6, None, levels=levels,
                               super_cap=2)
