"""The per-ray culls (accel.cuda_cull's kslots_cull and perray_cull, and
their plain versions) on the CPU.

- `kslots_cull_plain`, the plain version that the CPU runs and the card's
  kernel is held against, against the JAX package's CULL + EXTRACT of
  kslots' `_chunk_pipeline` (its `_ray_slab`, `_pack_bits` and `_peel_k`,
  built as tests/test_torch_kslots.py's `_jax_tables` builds them) at
  levels 1 and 2: cid, n_cand, over and the overflow split (over_supers,
  over_clusters, phantom_only), every slot of every row, pad included;
- `perray_cull_plain` against the JAX package's `_perray_candidates` in
  order_mode "id": order, n_cand, overflow (and the entries the query
  returns);
- both on the crafted cases of tests/test_torch_sweep_cases.py
  (ray_cull_case: dead, -0.0, +0.0, NaN and +inf t_max; axis-parallel rays
  whose origin lies on a slab plane; +-0.0 direction components; flat
  boxes; exactly k_supers / k_clusters / cap candidates and one more;
  phantom children alone and past k_clusters; cap > C and C < 32, C not a
  multiple of 32; an over-k_supers ray whose k_supers-th super is not the
  last, the pad rule) at their caps and one past each, and on a small
  random accel;
- each crafted case reaches its edge (on JAX's result);
- the plain versions do not depend on their row chunk;
- on the CPU kslots._tables and traverse._perray_candidates run the plain
  versions and launch nothing; the wrappers raise on CPU tensors, bad
  layouts and bad sizes before they build anything.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import kslots as jkslots
from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu_torch.accel import cuda_cull, kslots, traverse
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import _rays, _scene
from tests.test_torch_worklist_cull import _accels

SPLIT = ("over_supers", "over_clusters", "phantom_only")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kslots(ja, o, d, tm, t_min, ks, kc, levels):
    """JAX's CULL + EXTRACT (kslots.py:117-163) on one chunk: n_cand, over,
    cid and the overflow split, as the port's tables name them."""
    o, d, tm = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    r = o.shape[0]
    live = tm >= 0.0
    lo0 = jnp.full((r,), jnp.float32(t_min))
    hi0 = jnp.where(live, tm, -jnp.inf)
    ss, cs, c = ja.super_size, ja.num_supers, ja.num_clusters
    if levels == 2:
        cand_s = jkslots._ray_slab(ja.sbmin, ja.sbmax, o, d, lo0, hi0)
        over_s = jnp.sum(cand_s, axis=1) > ks
        sup = jkslots._peel_k(jkslots._pack_bits(cand_s), ks, cs)
        sup_c = jnp.minimum(sup, cs - 1)
        cand = jkslots._ray_slab(ja.cbmin[sup_c].reshape(r, ks * ss, 3),
                                 ja.cbmax[sup_c].reshape(r, ks * ss, 3),
                                 o, d, lo0, hi0)
        cand &= jnp.broadcast_to(sup[:, :, None] < cs,
                                 (r, ks, ss)).reshape(r, ks * ss)
        cid_table = (sup_c[:, :, None] * ss
                     + jnp.arange(ss)[None, None, :]).reshape(r, ks * ss)
    else:
        cand = jkslots._ray_slab(ja.bmin, ja.bmax, o, d, lo0, hi0)
        over_s = jnp.zeros((r,), bool)
        cid_table = jnp.broadcast_to(jnp.arange(c)[None, :], cand.shape)
    n_real = jnp.sum(cand & (cid_table < c), axis=1)
    n_cand = jnp.sum(cand, axis=1).astype(jnp.int32)
    over = over_s | (n_cand > kc)
    cand = cand & ~over[:, None]
    cols = cand.shape[1]
    slot = jkslots._peel_k(jkslots._pack_bits(cand), kc, cols)
    cid = jnp.minimum(jnp.take_along_axis(cid_table,
                                          jnp.minimum(slot, cols - 1), 1),
                      c - 1)
    over_c = over & ~over_s
    out = dict(n_cand=n_cand, over=over, cid=cid, over_supers=over_s,
               over_clusters=over_c,
               phantom_only=over_c & (n_real <= kc) & (levels == 2),
               n_slots=jnp.where(over, 0, n_cand))
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_perray(ja, o, d, tm, t_min, cap):
    """JAX's _perray_candidates in order_mode "id": (order, n_cand, entry,
    overflow)."""
    out = jtraverse._perray_candidates(
        ja, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(tm), cap,
        row_chunk=o.shape[0], order_mode="id")
    return tuple(np.asarray(x) for x in out)


def _kslots_plain(pa, case, ks, kc, levels, **kw):
    t = torch.as_tensor
    return cuda_cull.kslots_cull_plain(pa, t(case["o"]), t(case["d"]),
                                       t(case["tm"]), case["t_min"], ks, kc,
                                       levels, **kw)


def _assert_kslots(got, want):
    assert got["cid"].dtype == torch.int32
    assert got["n_slots"].dtype == torch.int32
    for key in ("cid", "n_cand", "over", "n_slots", *SPLIT):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


def _kslots_variants(case, levels):
    """(ks, kc) a case is held at: its own, and one past each."""
    ks, kc = case["ks"], case["kc"]
    out = [(ks, kc), (ks, kc + 1)]
    return out + [(ks + 1, kc)] if levels == 2 else out


@functools.lru_cache(maxsize=None)
def _jax_kslots_case(name, levels, ks, kc):
    """JAX's kslots tables of a crafted case (each computed once a
    process)."""
    case = cases.ray_cull_case(name)
    ja, _pa = _accels(case)
    return _jax_kslots(ja, case["o"], case["d"], case["tm"], case["t_min"],
                       ks, kc, levels)


@functools.lru_cache(maxsize=None)
def _jax_perray_case(name, cap):
    case = cases.ray_cull_case(name)
    ja, _pa = _accels(case)
    return _jax_perray(ja, case["o"], case["d"], case["tm"], case["t_min"],
                       cap)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("name", cases.RAY_CULL_CASES)
def test_kslots_plain_matches_jax_on_crafted_cases(name, levels):
    case = cases.ray_cull_case(name)
    _ja, pa = _accels(case)
    for ks, kc in _kslots_variants(case, levels):
        _assert_kslots(_kslots_plain(pa, case, ks, kc, levels),
                       _jax_kslots_case(name, levels, ks, kc))


@pytest.mark.parametrize("name", cases.RAY_CULL_CASES)
def test_perray_plain_matches_jax_on_crafted_cases(name):
    case = cases.ray_cull_case(name)
    _ja, pa = _accels(case)
    t = torch.as_tensor
    for cap in (case["cap"], case["cap"] + 1):
        want = _jax_perray_case(name, cap)
        got = traverse._perray_candidates(pa, t(case["o"]), t(case["d"]),
                                          case["t_min"], t(case["tm"]), cap)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        for a, b, key in zip(got, want, ("order", "n_cand", "entry",
                                         "overflow")):
            np.testing.assert_array_equal(a.numpy(), b, key)


def test_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    # count_edges: lines of 6 candidates in 2 supers, 7 in 2, 9 in 3
    case = cases.ray_cull_case("count_edges")
    ks, kc, cap = case["ks"], case["kc"], case["cap"]
    k2 = _jax_kslots_case("count_edges", 2, ks, kc)
    n1 = _jax_kslots_case("count_edges", 1, ks, kc)["n_cand"]
    assert {6, 7, 9} <= set(n1.tolist())
    assert ((n1 == kc) & ~k2["over"]).any()           # exactly kc
    assert (k2["over_clusters"] & (n1 == kc + 1)).any()  # kc + 1
    assert (k2["over_supers"] & (n1 == 9)).any()      # ks + 1 supers
    past = _jax_kslots_case("count_edges", 2, ks + 1, kc)
    assert not past["over_supers"].any()
    assert not _jax_kslots_case("count_edges", 2, ks, kc + 1)[
        "over"][n1 == kc + 1].any()
    order, n_cand, _e, overflow = _jax_perray_case("count_edges", cap)
    assert ((n_cand == cap) & ~overflow).any() and overflow.any()
    assert not _jax_perray_case("count_edges", cap + 1)[3][
        n1 == cap + 1].any()
    # overflow rays keep their first cap ids (not reset)
    assert (order[overflow] != case["bmin"].shape[0] - 1).all()
    # phantoms: 16 candidates (1 real) at exactly kc, 20 past it
    k = _jax_kslots_case("phantoms", 2, 6, 16)
    assert ((k["n_cand"] == 16) & ~k["over"]).any()
    assert (k["phantom_only"] & (k["n_cand"] == 20)).any()
    assert (k["cid"][k["n_cand"] == 16] == 48).all()
    # pad_rule: over k_supers, the k_supers-th super 3, not the last (9)
    k = _jax_kslots_case("pad_rule", 2, 2, 6)
    assert k["over_supers"].any() and (k["cid"][k["over_supers"]] == 15).all()
    # t_max_values: NaN, -0.0 and +inf t_max; a candidate at t_max -0.0
    case = cases.ray_cull_case("t_max_values")
    tm = case["tm"]
    for name_cap in (_jax_perray_case("t_max_values", case["cap"]),):
        n_cand = name_cap[1]
        assert (n_cand[np.isnan(tm)] == 0).all()
        assert (n_cand[(tm == 0) & np.signbit(tm)] > 0).any()
        assert (n_cand[np.isposinf(tm)] > 0).any()
    k = _jax_kslots_case("t_max_values", 2, case["ks"], case["kc"])
    assert (k["n_cand"][(tm == 0) & np.signbit(tm)] > 0).any()
    # axis_on_plane / signed_zero: origins on planes where d is 0
    for name in ("axis_on_plane", "signed_zero"):
        case = cases.ray_cull_case(name)
        zero = case["d"] == 0
        assert zero.any(axis=1).all()
        assert _jax_perray_case(name, case["cap"])[1].any()
    d = cases.ray_cull_case("signed_zero")["d"]
    assert (np.signbit(d) & (d == 0)).any() and (~np.signbit(d) & (d == 0)
                                                  ).any()
    # flat boxes are candidates
    case = cases.ray_cull_case("flat_boxes")
    assert (case["bmin"] == case["bmax"]).any(axis=1).all()
    assert _jax_perray_case("flat_boxes", case["cap"])[1].any()
    # small_c: cap and k_clusters past C, C < 32
    case = cases.ray_cull_case("small_c")
    c = case["bmin"].shape[0]
    assert case["cap"] > c < 32 and case["kc"] > c
    order, n_cand, entry, _o = _jax_perray_case("small_c", case["cap"])
    assert (order[:, c:] == 0).all() and np.isinf(entry[:, c:]).all()
    assert (n_cand > 1).any()
    assert cases.ray_cull_case("count_edges")["bmin"].shape[0] % 32


@pytest.mark.parametrize("levels", [1, 2])
def test_plain_matches_jax_on_a_random_accel(rng, levels):
    """The worklist tests' soup (500 triangles in clusters of 12, supers of
    4: the last super holds padding children) and rays with dead, per-ray
    and infinite t_max: both culls at caps most rays overflow and caps
    none does."""
    ja, pa, _ = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _rays(rng, 256)
    tm[1::3] = np.inf
    t = torch.as_tensor
    for ks, kc in ((2, 3), (pa.num_supers, pa.num_clusters)):
        want = _jax_kslots(ja, o, d, tm, 1e-3, ks, kc, levels)
        got = cuda_cull.kslots_cull_plain(pa, t(o), t(d), t(tm), 1e-3, ks,
                                          kc, levels)
        _assert_kslots(got, want)
        assert (got["n_cand"] > 0).any()
    if levels == 2:
        for cap in (3, 64):
            want = _jax_perray(ja, o, d, tm, 1e-3, cap)
            got = traverse._perray_candidates(pa, t(o), t(d), 1e-3, t(tm),
                                              cap)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("row_chunk", [1, 7, 1 << 15])
def test_plain_row_chunks_agree(row_chunk):
    case = cases.ray_cull_case("count_edges")
    _ja, pa = _accels(case)
    t = torch.as_tensor
    for levels in (1, 2):
        ref = _kslots_plain(pa, case, 2, 6, levels, row_chunk=5)
        got = _kslots_plain(pa, case, 2, 6, levels, row_chunk=row_chunk)
        assert all(torch.equal(ref[k], got[k]) for k in ref)
    args = (pa, t(case["o"]), t(case["d"]), case["t_min"], t(case["tm"]), 6)
    ref = cuda_cull.perray_cull_plain(*args, row_chunk=5)
    got = cuda_cull.perray_cull_plain(*args, row_chunk=row_chunk)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_queries_run_the_plain_versions_on_cpu(monkeypatch):
    case = cases.ray_cull_case("count_edges")
    _ja, pa = _accels(case)
    calls = []

    def no_kernel(*a, **k):
        raise AssertionError("a kernel's wrapper ran on the CPU")

    for name in ("kslots_cull_plain", "perray_cull_plain"):
        real = getattr(cuda_cull, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(cuda_cull, name, spy)
    monkeypatch.setattr(cuda_cull, "kslots_cull", no_kernel)
    monkeypatch.setattr(cuda_cull, "perray_cull", no_kernel)
    cuda_cull.reset_launches()
    t = torch.as_tensor
    o, d, tm = t(case["o"]), t(case["d"]), t(case["tm"])
    tab = kslots._tables(pa, o, d, tm, 1e-3, 2, 6, 2, 1 << 15)
    assert tab["cid"].shape == (128, 6)
    order, _n, entry, _o = traverse._perray_candidates(pa, o, d, 1e-3, tm, 6)
    assert order.shape == entry.shape == (128, 6)
    assert (entry == 0).all()
    # "entry" mode takes its own plain version (perray_entry_plain)
    traverse._perray_candidates(pa, o, d, 1e-3, tm, 6, order_mode="entry")
    assert calls == ["kslots_cull_plain", "perray_cull_plain"]
    assert cuda_cull.kslots_launches == cuda_cull.perray_launches == 0


def _wrapper_inputs(**change):
    case = cases.ray_cull_case("count_edges")
    _ja, pa = _accels(case)
    args = {"origins": torch.as_tensor(case["o"]),
            "directions": torch.as_tensor(case["d"]),
            "t_max": torch.as_tensor(case["tm"])}
    args.update(change)
    return pa, args


def _call(which, pa, args, **kw):
    if which == "perray":
        return cuda_cull.perray_cull(pa, args["origins"], args["directions"],
                                     1e-3, args["t_max"], kw.get("cap", 6))
    return cuda_cull.kslots_cull(pa, args["origins"], args["directions"],
                                 args["t_max"], 1e-3, kw.get("ks", 2),
                                 kw.get("kc", 6), kw.get("levels", which))


@pytest.mark.parametrize("which", [1, 2, "perray"])
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
])
def test_wrappers_raise(monkeypatch, which, bad, exc, match):
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    pa, args = _wrapper_inputs(**bad)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        _call(which, pa, args)
    assert cuda_cull.kslots_launches == cuda_cull.perray_launches == 0


@pytest.mark.parametrize("which,kw,match", [
    (2, dict(levels=3), "levels 1 or 2"),
    (2, dict(ks=0), "k_supers"),
    (2, dict(kc=-1), "k_clusters"),
    ("perray", dict(cap=-1), "cap"),
    (2, dict(box=("cbmin", torch.zeros((18, 4, 3), dtype=torch.float64))),
     "cbmin"),
    (1, dict(box=("bmin", torch.zeros((70, 3))[:, :2])), "shape|contiguous"),
])
def test_wrappers_raise_on_sizes_and_boxes(which, kw, match):
    """Bad levels, caps and box tables of the wrong type or shape raise
    before any launch (the 2-level tables are checked too)."""
    pa, args = _wrapper_inputs()
    if "box" in kw:
        name, x = kw.pop("box")
        setattr(pa, name, x)
    with pytest.raises((ValueError, TypeError), match=match):
        _call(which, pa, args, **kw)
