"""The exact shadow cull's and perray's entry order's crafted cases on the
CPU (accel.cuda_cull's exact_cull / perray_entry and their plain
versions).

- `exact_cull_plain`, the plain version that the CPU runs and the card's
  kernel is held against, against the JAX package's
  `_exact_block_candidates` bit for bit (order, n_cand, entry_sorted, whole
  rows) on every crafted case of tests/test_torch_sweep_cases.py
  (exact_case: an exact id of conservative entry +inf that lands past
  n_cand; blocks at n_sup = ksup and ksup + 1; all-dead blocks ahead of
  live ones in an unsorted wave; inverted padding children; axis-parallel
  lanes on box planes and -0.0 directions; entry ties; ksup >= Cs and
  kchild >= C), at the case's ksup and one past it, without and with a
  live-block count;
- `perray_entry_plain` against JAX's `_perray_candidates(order_mode=
  "entry")` (order, n_cand, entry, overflow) on the per-ray cull cases
  (ray_cull_case: entries tied at t_min, more candidates than cap, cap >
  C, NaN t_max) at three caps each;
- each crafted case reaches its edge (on JAX's result);
- on the CPU the dispatch takes the plain versions and launches nothing;
  the wrappers raise on CPU tensors, bad layouts and bad sizes before they
  build anything.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse
import test_torch_sweep_cases as cases  # tests/, numpy only

BOX_KEYS = ("bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(case):
    """(JAX's accel, the port's accel) of a crafted case: its box tables
    and sizes."""
    sizes = dict(num_clusters=case["bmin"].shape[0],
                 num_supers=case["sbmin"].shape[0], super_size=case["ss"])
    ja = SimpleNamespace(**{k: jnp.asarray(case[k]) for k in BOX_KEYS},
                         **sizes)
    pa = SimpleNamespace(**{k: T(case[k]) for k in BOX_KEYS}, **sizes)
    return ja, pa


def _live_blocks(tm_blk) -> int:
    """One past the last block with a live lane: the blocks from it on are
    all dead, so the count is valid on any wave (on a wave sorted
    dead-last, live_block_count)."""
    live = np.nonzero((tm_blk >= 0.0).any(axis=1))[0]
    return int(live[-1]) + 1 if live.size else 0


@functools.lru_cache(maxsize=None)
def _jax_exact(name, ksup, live):
    case = cases.exact_case(name)
    ja, _pa = _accels(case)
    lv = jnp.int32(_live_blocks(case["tm_blk"])) if live else None
    out = jtraverse._exact_block_candidates(
        ja, jnp.asarray(case["o_blk"]), jnp.asarray(case["d_blk"]),
        jnp.asarray(case["tm_blk"]), case["t_min"], ksup=ksup, row_chunk=2,
        live_blocks=lv)
    return tuple(np.asarray(a) for a in out)


def _plain_exact(case, ksup, live=False):
    _ja, pa = _accels(case)
    return cuda_cull.exact_cull_plain(
        pa, T(case["o_blk"]), T(case["d_blk"]), T(case["tm_blk"]),
        case["t_min"], ksup,
        _live_blocks(case["tm_blk"]) if live else None)


def _n_sup(case):
    """The supers each block's live lanes meet (the plain slab rule)."""
    _ja, pa = _accels(case)
    tm = T(case["tm_blk"])
    hi0 = torch.where(tm >= 0.0, tm, -float("inf"))
    return cuda_cull._slab_lanes(T(case["o_blk"]), T(case["d_blk"]), hi0,
                                 pa.sbmin, pa.sbmax,
                                 case["t_min"]).any(dim=1).sum(dim=1).numpy()


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("ksup_add", [0, 1])
@pytest.mark.parametrize("name", cases.EXACT_CASES)
def test_exact_cull_plain_matches_jax(name, ksup_add, live):
    case = cases.exact_case(name)
    ksup = case["ksup"] + ksup_add
    got = _plain_exact(case, ksup, live)
    want = _jax_exact(name, ksup, live)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1], "n_cand")
    np.testing.assert_array_equal(got[2].numpy().view(np.int32),
                                  want[2].view(np.int32), "entry_sorted")
    np.testing.assert_array_equal(got[0].numpy(), want[0], "order")


def test_exact_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    def in_cap(name, ksup):
        return _n_sup(cases.exact_case(name)) <= min(
            ksup, cases.exact_case(name)["sbmin"].shape[0])

    # inf_entry: cluster 7, an exact id of entry +inf, past n_cand
    case = cases.exact_case("inf_entry")
    order, n_cand, entry = _jax_exact("inf_entry", case["ksup"], False)
    c = case["bmin"].shape[0]
    at = np.argwhere((order[:3] == 7) & np.isinf(entry[:3]))
    assert len(at) == 3 and (n_cand[:3] == 2).all()
    assert all(p >= n_cand[b] for b, p in at)
    # the slot before it in the row is a sentinel (C - 1 at +inf)
    assert all(order[b, p - 1] == c - 1 and np.isposinf(entry[b, p - 1])
               for b, p in at)
    # dead_unsorted: the NaN t_max block's exact id of entry +inf at
    # ksup + 1; all-dead blocks before live ones; n_sup at ksup and + 1
    case = cases.exact_case("dead_unsorted")
    ks = case["ksup"]
    live = (case["tm_blk"] >= 0).any(axis=1)
    assert not live[0] and live[3:].any() and not live[-1]
    n_sup = _n_sup(case)
    assert (n_sup == ks).any() and (n_sup == ks + 1).any()
    order, n_cand, entry = _jax_exact("dead_unsorted", ks + 1, False)
    nan_blk = np.isnan(case["tm_blk"]).any(axis=1)
    assert (n_cand[nan_blk] > 0).all()
    assert np.isposinf(entry[nan_blk, :n_cand[nan_blk][0]]).all()
    # super_edge: blocks at n_sup = ksup (in the cap) and ksup + 1
    case = cases.exact_case("super_edge")
    n_sup = _n_sup(case)
    assert set(n_sup.tolist()) == {case["ksup"], case["ksup"] + 1}
    # inverted_children: the last super (1 real, 15 inverted children)
    # listed, its padding failed: the line's 5 clusters exactly
    case = cases.exact_case("inverted_children")
    assert (case["cbmin"][-1, 1:] > case["cbmax"][-1, 1:]).all()
    order, n_cand, _e = _jax_exact("inverted_children", case["ksup"], False)
    assert (n_cand == 5).all()
    assert (np.sort(order[:, :5], axis=1) == np.arange(44, 49)).all()
    # axis_planes: +-0.0 components (a block of -0.0 only) and blocks
    # within the shortlist with candidates
    case = cases.exact_case("axis_planes")
    d = case["d_blk"]
    assert ((d == 0) & np.signbit(d)).any() and ((d == 0)
                                                  & ~np.signbit(d)).any()
    assert (np.signbit(d[0][d[0] == 0])).all()
    ok = in_cap("axis_planes", case["ksup"])
    assert ok.any() and (~ok).any()
    n_cand = _jax_exact("axis_planes", case["ksup"], False)[1]
    assert (n_cand[ok] > 0).all()
    # entry_ties: in-cap rows with equal entries (0 among them)
    case = cases.exact_case("entry_ties")
    order, n_cand, entry = _jax_exact("entry_ties", case["ksup"], False)
    ok = in_cap("entry_ties", case["ksup"])
    ties = zeros = 0
    for b in np.nonzero(ok)[0]:
        e = entry[b, :n_cand[b]]
        ties += len(e) - len(np.unique(e))
        zeros += int((e == 0).sum() > 1)
    assert ties > 0 and zeros > 0
    # whole_shortlist: ksup >= Cs, kchild >= C (C not a multiple of ss)
    case = cases.exact_case("whole_shortlist")
    cs, ss, c = case["sbmin"].shape[0], case["ss"], case["bmin"].shape[0]
    assert case["ksup"] >= cs and case["ksup"] * ss >= c and c % ss
    assert (_jax_exact("whole_shortlist", case["ksup"], False)[1] > 0).all()


def test_exact_dispatch_runs_the_plain_version_on_cpu(monkeypatch):
    """On the CPU _exact_block_candidates is exact_cull_plain (live_blocks
    passed on) and the packet cascade reads the live-block count; nothing
    launches."""
    case = cases.exact_case("super_edge")
    _ja, pa = _accels(case)
    seen = []
    real = cuda_cull.exact_cull_plain

    def spy(*a, **k):
        seen.append(a[6] if len(a) > 6 else k.get("live_blocks"))
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(cuda_cull, "exact_cull_plain", spy)
    monkeypatch.setattr(cuda_cull, "exact_cull", no_kernel)
    cuda_cull.reset_launches()
    blk = [T(case[k]) for k in ("o_blk", "d_blk", "tm_blk")]
    got = traverse._exact_block_candidates(pa, *blk, case["t_min"],
                                           ksup=3, live_blocks=5)
    assert seen == [5]
    want = real(pa, *blk, case["t_min"], 3, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # any_hit_packets at exact_cull on the CPU: the sorted wave's live-block
    # count, read once and passed to the plain version
    from tests.test_torch_exact_cull import _scene

    rng = np.random.default_rng(5)
    _j, acc, _t = _scene(rng, 300, 8)
    o = rng.uniform(-6.0, 6.0, (256, 3)).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(np.arange(256) % 3 == 0, -1.0, 9.0).astype(np.float32)
    counts = []
    real_count = traverse.live_block_count
    monkeypatch.setattr(traverse, "live_block_count",
                        lambda t: counts.append(1) or real_count(t))
    seen.clear()
    traverse.any_hit_packets(acc, T(o), T(d), 1e-3, T(tm), block_size=64,
                             exact_cull=4)
    # 170 live rays sorted first: 3 of the 4 blocks of 64 hold live lanes
    assert counts == [1] and seen == [3]
    assert cuda_cull.exact_launches == cuda_cull.launches == 0


def test_nan_t_max_lane_hides_a_block_like_jax():
    """A deviation that JAX shares (ROADMAP section 3): a lane with a NaN
    t_max makes its block's max t_max NaN, so the interval cull lists no
    cluster and the block's live lanes miss their hits; the exact cull
    finds them where its shortlist holds every super the lanes meet, and
    misses them where the block overflows to the (empty) conservative list
    or an exact id of entry +inf lands past n_cand. Every form: the port's
    occlusion equals JAX's."""
    from tests.test_torch_exact_cull import _scene
    from path_tracer_ai_tpu_torch.engine import intersect

    rng = np.random.default_rng(7)
    ja, pa, pt = _scene(rng, 600, 16)
    n = 512
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 15.0, n).astype(np.float32)
    hit = intersect.any_hit(pt, T(o), T(d), 1e-3, T(tm)).numpy()
    i = np.nonzero(hit)[0][0]
    o[0], d[0], tm[0] = o[i], d[i], tm[i]
    tm[1:64] = np.nan  # block 0: lane 0 live, the rest NaN
    want = intersect.any_hit(pt, T(o), T(d), 1e-3, T(tm)).numpy()
    assert want[0]
    found = {}
    for ksup in (0, 4, 16):
        kw = dict(block_size=64, sort=False, exact_cull=ksup)
        got = traverse.any_hit_packets(pa, T(o), T(d), 1e-3, T(tm),
                                       **kw).numpy()
        got_j = np.asarray(jtraverse.any_hit_packets(
            ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm), **kw))
        np.testing.assert_array_equal(got, got_j)
        np.testing.assert_array_equal(got[64:], want[64:])
        found[ksup] = bool(got[0])
    assert found == {0: False, 4: False, 16: True}


def _exact_wrapper_inputs(**change):
    case = cases.exact_case("super_edge")
    _ja, pa = _accels(case)
    args = {k: T(case[k]) for k in ("o_blk", "d_blk", "tm_blk")}
    for name, x in change.items():
        if name in args:
            args[name] = x
        else:
            setattr(pa, name, x)
    return pa, args


@pytest.mark.parametrize("bad,exc,match", [
    ({}, ValueError, "CUDA kernel"),
    ({"o_blk": torch.zeros((8, 8, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"tm_blk": torch.zeros((8, 8), dtype=torch.int32)}, TypeError,
     "float32"),
    ({"d_blk": torch.zeros((3, 8, 8)).permute(1, 2, 0)}, ValueError,
     "contiguous"),
    ({"tm_blk": torch.zeros((8, 16))[:, ::2]}, ValueError, "contiguous"),
    ({"o_blk": torch.zeros((64, 3))}, ValueError, "dims"),
    ({"cbmin": torch.zeros((18, 4, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"cbmin": torch.zeros((18, 3, 3)), "cbmax": torch.zeros((18, 3, 3))},
     ValueError, "children"),
    ({"sbmin": torch.zeros((17, 3)), "sbmax": torch.zeros((17, 3))},
     ValueError, "supers"),
    ({"ksup": 0}, ValueError, "ksup"),
])
def test_exact_wrapper_raises(monkeypatch, bad, exc, match):
    """Bad rays, box tables and ksup raise before anything is built or
    launched; CPU tensors raise (the CPU takes exact_cull_plain)."""
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    bad = dict(bad)
    ksup = bad.pop("ksup", 3)
    pa, args = _exact_wrapper_inputs(**bad)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        cuda_cull.exact_cull(pa, args["o_blk"], args["d_blk"],
                             args["tm_blk"], 1e-3, ksup)
    assert cuda_cull.exact_launches == cuda_cull.launches == 0


# ---- perray's entry order --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_entry(name, cap):
    case = cases.ray_cull_case(name)
    ja, _pa = _accels(case)
    out = jtraverse._perray_candidates(
        ja, jnp.asarray(case["o"]), jnp.asarray(case["d"]), case["t_min"],
        jnp.asarray(case["tm"]), cap, row_chunk=case["o"].shape[0],
        order_mode="entry")
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("name", cases.RAY_CULL_CASES)
def test_perray_entry_plain_matches_jax(name):
    """traverse._perray_candidates(order_mode="entry") on the CPU (the plain
    version) against JAX's: order, n_cand, entry bit for bit, overflow."""
    case = cases.ray_cull_case(name)
    _ja, pa = _accels(case)
    for cap in cases.perray_entry_caps(case):
        got = traverse._perray_candidates(pa, T(case["o"]), T(case["d"]),
                                          case["t_min"], T(case["tm"]), cap,
                                          order_mode="entry")
        want = _jax_entry(name, cap)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        for key, a, b in zip(("order", "n_cand", "entry", "overflow"), got,
                             want):
            a = a.numpy()
            if key == "entry":
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, f"{key} at cap {cap}")


def test_perray_entry_cases_reach_their_edges():
    """Entries tied at t_min, more candidates than cap (the top-cap
    selection), cap > C, NaN t_max (no candidate) and +inf t_max."""
    case = cases.ray_cull_case("small_c")
    c = case["bmin"].shape[0]
    order, n_cand, entry, _o = _jax_entry("small_c", case["cap"])
    assert case["cap"] > c
    assert (order[:, c:] == 0).all() and np.isinf(entry[:, c:]).all()
    assert ((entry == case["t_min"]).sum(axis=1) > 1).any()
    case = cases.ray_cull_case("count_edges")
    order, n_cand, entry, over = _jax_entry("count_edges", case["cap"])
    assert over.any() and np.isfinite(entry[over]).all()
    _o, _n, e1, over1 = _jax_entry("count_edges", 1)
    assert over1.any() and np.isfinite(e1[over1]).all()
    case = cases.ray_cull_case("t_max_values")
    tm = case["tm"]
    order, n_cand, entry, _o = _jax_entry("t_max_values", case["cap"])
    kx = min(case["cap"], case["bmin"].shape[0])
    assert (n_cand[np.isnan(tm)] == 0).all()
    assert (order[np.isnan(tm), :kx] == np.arange(kx)).all()
    assert (n_cand[np.isposinf(tm)] > 0).any()


def test_perray_entry_row_chunk_does_not_change_the_lists():
    case = cases.ray_cull_case("small_c")
    _ja, pa = _accels(case)
    args = (pa, T(case["o"]), T(case["d"]), case["t_min"], T(case["tm"]), 5)
    ref = cuda_cull.perray_entry_plain(*args)
    for row_chunk in (1, 7):
        got = cuda_cull.perray_entry_plain(*args, row_chunk=row_chunk)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_perray_entry_dispatch_runs_the_plain_version_on_cpu(monkeypatch):
    case = cases.ray_cull_case("count_edges")
    _ja, pa = _accels(case)
    calls = []
    real = cuda_cull.perray_entry_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(cuda_cull, "perray_entry_plain", spy)
    monkeypatch.setattr(cuda_cull, "perray_entry", no_kernel)
    cuda_cull.reset_launches()
    traverse._perray_candidates(pa, T(case["o"]), T(case["d"]), 1e-3,
                                T(case["tm"]), 6, order_mode="entry")
    assert calls == [1] and cuda_cull.entry_launches == 0


@pytest.mark.parametrize("bad,exc,match", [
    ({}, ValueError, "CUDA kernel"),
    ({"origins": torch.zeros((128, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"directions": torch.zeros((3, 128)).t()}, ValueError, "contiguous"),
    ({"t_max": torch.zeros((64,))}, ValueError, r"\[N\]"),
    ({"cap": -1}, ValueError, "cap"),
])
def test_perray_entry_wrapper_raises(monkeypatch, bad, exc, match):
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    case = cases.ray_cull_case("count_edges")
    _ja, pa = _accels(case)
    args = {"origins": T(case["o"]), "directions": T(case["d"]),
            "t_max": T(case["tm"]), "cap": 6}
    args.update(bad)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        cuda_cull.perray_entry(pa, args["origins"], args["directions"],
                               1e-3, args["t_max"], args["cap"])
    assert cuda_cull.entry_launches == 0
