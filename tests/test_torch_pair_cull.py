"""The pair tables' CULL + PACK (accel.cuda_cull's pair_tables and its
plain version) on the CPU.

- `pair_tables_plain`, the plain version that the CPU runs and the card's
  kernels are held against, against the JAX package's `build_pair_tables`
  (path_tracer_ai_tpu/accel/pairs.py): pair_ray, tile_cluster, dst,
  n_cand, overflow and n_tiles, every slot, on the crafted cases of
  tests/test_torch_sweep_cases.py (pair_case: dead, -0.0, +0.0, NaN and
  +inf t_max; origins on slab planes of axis-parallel rays; +-0.0
  direction components; flat boxes; exactly cap candidates and cap + 1;
  rays over the pair budget between rays that are not; C < cap) at their
  cap and one past it, and on a small random accel at caps and budgets
  most rays overflow and none does;
- each crafted case reaches its edge (on JAX's result);
- the plain version depends on neither its row step nor PAIR_CULL_ELEMS
  (a cluster's rays straddle the steps); the kernels' ray tiles follow
  the wave's size;
- on the CPU the pair queries and the worklist's fallback run the plain
  version and launch nothing; the wrapper raises on CPU tensors, bad
  layouts and bad sizes before it builds anything.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pairs as jpairs
from path_tracer_ai_tpu_torch.accel import cuda_cull, pairs, worklist
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import _rays, _scene

FIELDS = ("pair_ray", "tile_cluster", "dst", "n_cand", "overflow", "n_tiles")
JAX_ROW_CHUNK = 32
ROW_STEP = 5  # the plain version's row step on the crafted cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(case):
    """(JAX's accel, the port's accel): the cluster boxes and their count."""
    c = case["bmin"].shape[0]
    ja = SimpleNamespace(bmin=jnp.asarray(case["bmin"]),
                         bmax=jnp.asarray(case["bmax"]), num_clusters=c)
    pa = SimpleNamespace(bmin=torch.as_tensor(case["bmin"]),
                         bmax=torch.as_tensor(case["bmax"]), num_clusters=c)
    return ja, pa


def _sizes(case, cap=None, budget=None):
    return dict(cap=case["cap"] if cap is None else cap,
                pair_budget=case["pair_budget"] if budget is None else budget,
                tile_rays=case["tile_rays"], pair_align=case["pair_align"])


def _jax(ja, o, d, tm, t_min, kw):
    out = jpairs.build_pair_tables(ja, jnp.asarray(o), jnp.asarray(d), t_min,
                                   jnp.asarray(tm), row_chunk=JAX_ROW_CHUNK,
                                   **kw)
    return {k: np.asarray(v) for k, v in zip(FIELDS, out)}


@functools.lru_cache(maxsize=None)
def _jax_case(name, cap=None, budget=None):
    case = cases.pair_case(name)
    ja, _pa = _accels(case)
    return _jax(ja, case["o"], case["d"], case["tm"], case["t_min"],
                _sizes(case, cap, budget))


def _plain(pa, case, row_chunk=ROW_STEP, **kw):
    t = torch.as_tensor
    return cuda_cull.pair_tables_plain(
        pa, t(case["o"]), t(case["d"]), case["t_min"], t(case["tm"]),
        **(kw or _sizes(case)), row_chunk=row_chunk)


def _assert_tables(got, want):
    got = dict(zip(FIELDS, got))
    for key in ("pair_ray", "tile_cluster", "dst", "n_cand", "n_tiles"):
        assert got[key].dtype == torch.int32, key
    assert got["overflow"].dtype == torch.bool
    assert got["n_tiles"].shape == ()
    for key in FIELDS:
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("name", sorted(cases.PAIR_CASES))
def test_plain_matches_jax_on_crafted_cases(name):
    case = cases.pair_case(name)
    _ja, pa = _accels(case)
    for cap in (case["cap"], case["cap"] + 1):
        _assert_tables(_plain(pa, case, **_sizes(case, cap)),
                       _jax_case(name, cap))


def _true_counts(name):
    """Every ray's candidate count (JAX, cap C, a budget none passes)."""
    c = cases.pair_case(name)["bmin"].shape[0]
    return _jax_case(name, c, c)["n_cand"]


def test_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    # count_edges: exactly cap candidates stay, cap + 1 overflow
    case = cases.pair_case("count_edges")
    cap = case["cap"]
    n = _true_counts("count_edges")
    j = _jax_case("count_edges")
    assert ((n == cap) & ~j["overflow"] & (j["n_cand"] == cap)).any()
    assert (j["overflow"][n == cap + 1]).all() and (n == cap + 1).any()
    assert (j["n_cand"][j["overflow"]] == 0).all()
    assert not _jax_case("count_edges", cap + 1)["overflow"][n == cap + 1].any()
    # over_budget: rays within cap but past the budget, between rays that
    # are not; their dst rows all P; their pairs still in the segments
    case = cases.pair_case("over_budget")
    n = _true_counts("over_budget")
    j = _jax_case("over_budget")
    p_cap = j["pair_ray"].shape[0]
    ob = j["overflow"] & (n <= case["cap"]) & (n > 0)
    kept = ~j["overflow"] & (j["n_cand"] > 0)
    first, last = np.nonzero(ob)[0][[0, -1]]
    assert kept[first + 1:last].any()
    assert (j["dst"][ob] == p_cap).all()
    wide = _jax_case("over_budget", budget=64)
    assert not wide["overflow"][ob].any()
    np.testing.assert_array_equal(j["tile_cluster"],
                                  wide["tile_cluster"][:p_cap // 4])
    assert int(wide["n_tiles"]) * 4 > p_cap  # the pairs pass P
    # small_c: C < cap, dst padded from C to cap with P
    case = cases.pair_case("small_c")
    c = case["bmin"].shape[0]
    j = _jax_case("small_c")
    assert c < case["cap"] and (j["dst"][:, c:] == j["pair_ray"].shape[0]
                                ).all()
    assert (j["n_cand"] > 1).any()
    # t_max_values: NaN and negative t_max give nothing; -0.0 and +inf do
    case = cases.pair_case("t_max_values")
    tm = case["tm"]
    n = _true_counts("t_max_values")
    assert (n[np.isnan(tm) | (tm < 0)] == 0).all()
    assert (n[(tm == 0) & np.signbit(tm)] > 0).any()
    assert (n[np.isposinf(tm)] > 0).any()
    # axis_on_plane / signed_zero / flat_boxes: candidates on those edges
    for name in ("axis_on_plane", "signed_zero", "flat_boxes"):
        case = cases.pair_case(name)
        assert (_true_counts(name) > 0).any()
    d = cases.pair_case("signed_zero")["d"]
    assert (np.signbit(d) & (d == 0)).any()
    assert (cases.pair_case("flat_boxes")["bmin"]
            == cases.pair_case("flat_boxes")["bmax"]).any(axis=1).all()
    assert cases.pair_case("axis_on_plane")["pair_align"] == 2
    # a cluster's rays straddle the plain version's row steps
    j = _jax_case("count_edges")
    t = cases.pair_case("count_edges")["tile_rays"]
    ray = j["pair_ray"].reshape(-1, t)
    straddle = [set(r[r >= 0] // ROW_STEP) for r in ray]
    assert any(len(s) > 1 for s in straddle)


@pytest.mark.parametrize("cap,budget", [(3, 1), (64, 12), (8, 2)])
def test_plain_matches_jax_on_a_random_accel(rng, cap, budget):
    """The worklist tests' soup (500 triangles in clusters of 12) and rays
    with dead, per-ray and infinite t_max, at a cap most rays overflow, the
    fallback's cap and budget, and a budget some rays pass."""
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _rays(rng, 256)
    tm[1::3] = np.inf
    kw = dict(cap=cap, pair_budget=budget, tile_rays=8, pair_align=2)
    want = _jax(ja, o, d, tm, 1e-3, kw)
    t = torch.as_tensor
    got = cuda_cull.pair_tables_plain(pa, t(o), t(d), 1e-3, t(tm), **kw,
                                      row_chunk=37)
    _assert_tables(got, want)
    assert (want["n_cand"] > 0).any()
    # build_pair_tables takes the plain version on the CPU
    tables = pairs.build_pair_tables(pa, t(o), t(d), 1e-3, t(tm),
                                     row_chunk=37, **kw)
    _assert_tables(tables, want)


@pytest.mark.parametrize("row_chunk", [1, 7, 1 << 15])
def test_plain_row_steps_agree(monkeypatch, row_chunk):
    """The tables do not depend on the row step, nor on PAIR_CULL_ELEMS."""
    for name in ("count_edges", "over_budget", "t_max_values"):
        case = cases.pair_case(name)
        _ja, pa = _accels(case)
        ref = _plain(pa, case, row_chunk=ROW_STEP)
        got = _plain(pa, case, row_chunk=row_chunk)
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), name
        monkeypatch.setattr(cuda_cull, "PAIR_CULL_ELEMS", 3 * 70)
        got = _plain(pa, case, row_chunk=row_chunk)
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), name


@pytest.mark.parametrize("n,tiles,least,rt", [
    (100, 512, 8, 8), (8192, 512, 8, 16), (32768, 512, 8, 64),
    (1 << 17, 512, 8, 256), (100, 1 << 30, 1, 1), (100, 1, 8, 100)])
def test_tile_rays(monkeypatch, n, tiles, least, rt):
    """About PAIR_TILES ray tiles a call, at least PAIR_MIN_TILE_RAYS rays
    a tile (the GPU tests set both to force one ray a tile and one tile a
    call)."""
    monkeypatch.setattr(cuda_cull, "PAIR_TILES", tiles)
    monkeypatch.setattr(cuda_cull, "PAIR_MIN_TILE_RAYS", least)
    assert cuda_cull.pair_tile_rays(n) == rt


def test_empty_wave():
    case = cases.pair_case("count_edges")
    _ja, pa = _accels(case)
    z = torch.zeros((0, 3))
    out = cuda_cull.pair_tables_plain(pa, z, z, 1e-3, torch.zeros((0,)), 6,
                                      8, 4)
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0, 6), (0,), (0,),
                                             ()]
    assert int(out[5]) == 0


def test_queries_run_the_plain_version_on_cpu(monkeypatch):
    """closest_hit_pairs, any_hit_pairs and the worklist's overflow
    fallback build their tables with the plain version on the CPU and
    launch nothing."""
    rng = np.random.default_rng(3)
    _ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _rays(rng, 128)
    calls = []
    real = cuda_cull.pair_tables_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the kernels' wrapper ran on the CPU")

    monkeypatch.setattr(cuda_cull, "pair_tables_plain", spy)
    monkeypatch.setattr(cuda_cull, "pair_tables", no_kernel)
    cuda_cull.reset_launches()
    t = torch.as_tensor
    h = pairs.closest_hit_pairs(pa, t(o), t(d), 1e-3, t(tm), cap=8)
    occ = pairs.any_hit_pairs(pa, t(o), t(d), 1e-3, t(tm), cap=8)
    assert h.hit.any() and occ.any()
    over = torch.zeros(128, dtype=torch.bool)
    over[::3] = True
    worklist._overflow_fallback(pa, t(o), t(d), 1e-3, t(tm), over, True,
                                4096, 64)
    assert len(calls) == 3
    assert cuda_cull.pair_launches == 0


def _wrapper_args(**change):
    case = cases.pair_case("count_edges")
    _ja, pa = _accels(case)
    args = {"origins": torch.as_tensor(case["o"]),
            "directions": torch.as_tensor(case["d"]),
            "t_max": torch.as_tensor(case["tm"])}
    args.update(change)
    return pa, args


@pytest.mark.parametrize("bad,exc,match", [
    ({}, ValueError, "CUDA kernel"),
    ({"origins": torch.zeros((128, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"t_max": torch.zeros((128,), dtype=torch.int32)}, TypeError,
     "float32"),
    ({"directions": torch.zeros((3, 128)).t()}, ValueError, "contiguous"),
    ({"t_max": torch.zeros((256,))[::2]}, ValueError, "contiguous"),
    ({"origins": torch.zeros((128, 3, 1))}, ValueError, "dims"),
    ({"t_max": torch.zeros((64,))}, ValueError, r"\[N\]"),
    ({"cap": -1}, ValueError, "cap >= 0"),
    ({"pair_budget": -1}, ValueError, "pair_budget"),
    ({"tile_rays": 0}, ValueError, "tile_rays"),
    ({"pair_align": 0}, ValueError, "pair_align"),
])
def test_wrapper_raises(monkeypatch, bad, exc, match):
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernels")

    monkeypatch.setattr(cuda_build, "load", no_build)
    sizes = {k: bad.pop(k) for k in ("cap", "pair_budget", "tile_rays",
                                     "pair_align") if k in bad}
    pa, args = _wrapper_args(**bad)
    kw = dict(cap=6, pair_budget=8, tile_rays=4, pair_align=1)
    kw.update(sizes)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        cuda_cull.pair_tables(pa, args["origins"], args["directions"], 1e-3,
                              args["t_max"], **kw)
    assert cuda_cull.pair_launches == 0
