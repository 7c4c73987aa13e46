"""The packet cascades' interval cull (accel.cuda_cull) on the CPU.

- `block_candidates_plain`, the plain version that the CPU runs and the
  card's kernel is held against, against the JAX package's
  `_block_candidates` on the crafted cull cases of
  tests/test_torch_sweep_cases.py (cull_case: all-dead and mixed blocks,
  +0.0 / -0.0 direction components, entries tied at 0 and above it, flat
  boxes, every cluster a candidate, t_max = +inf, entries of +inf) at small
  sizes: order and n_cand equal, entry_sorted equal as values (-0.0 ==
  +0.0);
- with_entry=False: the same order and n_cand, no entries;
- on the CPU traverse._block_candidates runs the plain version and
  launches nothing;
- the kernel's wrapper raises on a CPU tensor, a wrong dtype and a
  non-contiguous input, before it builds anything.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse
import test_torch_sweep_cases as cases  # tests/, numpy only


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(case):
    ja = SimpleNamespace(bmin=jnp.asarray(case["bmin"]),
                         bmax=jnp.asarray(case["bmax"]))
    pa = SimpleNamespace(bmin=torch.as_tensor(case["bmin"]),
                         bmax=torch.as_tensor(case["bmax"]),
                         num_clusters=case["bmin"].shape[0])
    return ja, pa


def _jax(case):
    ja, _pa = _accels(case)
    out = jtraverse._block_candidates(ja, jnp.asarray(case["o"]),
                                      jnp.asarray(case["d"]),
                                      jnp.asarray(case["tm"]))
    return tuple(np.asarray(x) for x in out)


def _plain(case, **kw):
    _ja, pa = _accels(case)
    return cuda_cull.block_candidates_plain(
        pa, torch.as_tensor(case["o"]), torch.as_tensor(case["d"]),
        torch.as_tensor(case["tm"]), **kw)


@pytest.mark.parametrize("nb,r,c", cases.CULL_SIZES)
@pytest.mark.parametrize("name", cases.CULL_CASES)
def test_plain_matches_jax(name, nb, r, c):
    case = cases.cull_case(name, nb, r, c)
    oj, nj, ej = _jax(case)
    ot, nt, et = _plain(case)
    assert ot.dtype == torch.int32 and nt.dtype == torch.int32
    np.testing.assert_array_equal(nt.numpy(), nj)
    np.testing.assert_array_equal(ot.numpy(), oj)
    # as values: max(lb, 0) may give either zero, and both sort as one key
    np.testing.assert_array_equal(et.numpy() == ej, np.ones_like(ej, bool))
    assert not np.isnan(et.numpy()).any()


def test_cases_reach_their_edges():
    """The crafted cases hold what they are named for (on JAX's result)."""
    n_sz = cases.CULL_SIZES[0]
    _o, n_dead, _e = _jax(cases.cull_case("dead_blocks", *n_sz))
    assert n_dead[0] == 0 and (n_dead[1:] > 0).any()
    o_all, n_all, e_all = _jax(cases.cull_case("all_candidates", *n_sz))
    assert (n_all == n_sz[2]).all() and (e_all == 0).all()
    np.testing.assert_array_equal(o_all, np.broadcast_to(
        np.arange(n_sz[2]), o_all.shape))
    _o, n_inf, e_inf = _jax(cases.cull_case("inf_entry", *n_sz))
    n_fin = np.isfinite(e_inf).sum(axis=1)
    assert (n_inf > n_fin).any()  # candidates whose entry is +inf
    for name in ("inside", "signed_zero"):
        _o, n, e = _jax(cases.cull_case(name, *n_sz))
        assert ((e == 0).sum(axis=1) > 1).any()  # entries tied at 0
    _o, n, e = _jax(cases.cull_case("ties", *n_sz))
    pos = np.where(np.isfinite(e) & (e > 0), e, np.nan)
    assert (pos[:, 1:] == pos[:, :-1]).any()  # tied above 0


def test_signed_zero_case_has_negative_zero_bounds():
    """signed_zero gives lb = -0.0 for its flat boxes: the entries the plain
    version sorts include a -0.0 or a +0.0 that JAX's canonical sort takes
    for the same key."""
    case = cases.cull_case("signed_zero", *cases.CULL_SIZES[0])
    _ja, pa = _accels(case)
    t = torch.as_tensor
    lb, _ub = traverse._block_interval_bounds(
        pa, t(case["o"]), t(case["d"]), live=t(case["tm"]) >= 0.0)
    assert (torch.signbit(lb) & (lb == 0)).any()


@pytest.mark.parametrize("name", ["coherent", "inf_entry", "dead_blocks"])
def test_plain_without_entry(name):
    case = cases.cull_case(name, *cases.CULL_SIZES[1])
    o1, n1, e1 = _plain(case)
    o2, n2, e2 = _plain(case, with_entry=False)
    assert e1 is not None and e2 is None
    assert torch.equal(o1, o2) and torch.equal(n1, n2)


@pytest.mark.parametrize("row_chunk", [1, 5, 8192])
def test_plain_row_chunks_agree(row_chunk):
    case = cases.cull_case("coherent", *cases.CULL_SIZES[2])
    ref = _plain(case)
    got = _plain(case, row_chunk=row_chunk)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_traverse_runs_the_plain_version_on_cpu(monkeypatch):
    case = cases.cull_case("coherent", *cases.CULL_SIZES[0])
    _ja, pa = _accels(case)
    calls = []

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    real = cuda_cull.block_candidates_plain

    def spy(*a, **k):
        calls.append(k.get("with_entry", a[4] if len(a) > 4 else True))
        return real(*a, **k)

    monkeypatch.setattr(cuda_cull, "block_candidates", no_kernel)
    monkeypatch.setattr(cuda_cull, "block_candidates_plain", spy)
    cuda_cull.reset_launches()
    t = torch.as_tensor
    got = traverse._block_candidates(pa, t(case["o"]), t(case["d"]),
                                     t(case["tm"]))
    got_ne = traverse._block_candidates(pa, t(case["o"]), t(case["d"]),
                                        t(case["tm"]), with_entry=False)
    assert calls == [True, False]
    assert cuda_cull.launches == 0
    want = real(pa, t(case["o"]), t(case["d"]), t(case["tm"]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got_ne[2] is None and torch.equal(got_ne[0], want[0])


def test_any_hit_packets_takes_no_entries(monkeypatch):
    """The shadow cascade does not read the entries: it asks for none."""
    case = cases.cull_case("coherent", *cases.CULL_SIZES[0])
    _ja, pa = _accels(case)
    seen = []
    real = traverse._block_candidates

    def spy(*a, with_entry=True):
        seen.append(with_entry)
        return real(*a, with_entry=with_entry)

    monkeypatch.setattr(traverse, "_block_candidates", spy)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(traverse, "pack_block_rays", stop)
    o = torch.as_tensor(case["o"]).reshape(-1, 3)
    d = torch.as_tensor(case["d"]).reshape(-1, 3)
    tm = torch.as_tensor(case["tm"]).reshape(-1)
    with pytest.raises(Stop):
        traverse.any_hit_packets(pa, o, d, 1e-3, tm, block_size=16,
                                 sort=False, tri_pack=torch.zeros(1))
    with pytest.raises(Stop):
        traverse.closest_hit_packets(pa, o, d, 1e-3, tm, block_size=16,
                                     sort=False, tri_pack=torch.zeros(1))
    assert seen == [False, True]


def _wrapper_inputs(**change):
    case = cases.cull_case("coherent", *cases.CULL_SIZES[0])
    _ja, pa = _accels(case)
    args = {"o_blk": torch.as_tensor(case["o"]),
            "d_blk": torch.as_tensor(case["d"]),
            "tm_blk": torch.as_tensor(case["tm"])}
    args.update(change)
    return pa, args


@pytest.mark.parametrize("bad,exc,match", [
    ({}, ValueError, "CUDA kernel"),
    ({"o_blk": torch.zeros((16, 16, 3), dtype=torch.float64)}, TypeError,
     "float32"),
    ({"tm_blk": torch.zeros((16, 16), dtype=torch.int32)}, TypeError,
     "float32"),
    ({"d_blk": torch.zeros((16, 3, 16)).transpose(1, 2)}, ValueError,
     "contiguous"),
    ({"tm_blk": torch.zeros((16, 32))[:, ::2]}, ValueError, "contiguous"),
    ({"o_blk": torch.zeros((16, 16))}, ValueError, "dims"),
])
def test_wrapper_raises(monkeypatch, bad, exc, match):
    from path_tracer_ai_tpu_torch import cuda_build

    def no_build(name):
        raise AssertionError("the wrapper built the kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    pa, args = _wrapper_inputs(**bad)
    cuda_cull.reset_launches()
    with pytest.raises(exc, match=match):
        cuda_cull.block_candidates(pa, args["o_blk"], args["d_blk"],
                                   args["tm_blk"])
    assert cuda_cull.launches == 0


def test_wrapper_raises_on_boxes():
    """A box table that is not f32 raises too (the boxes are checked like
    the rays)."""
    pa, args = _wrapper_inputs()
    pa.bmin = pa.bmin.double()
    with pytest.raises(TypeError, match="bmin"):
        cuda_cull.block_candidates(pa, args["o_blk"], args["d_blk"],
                                   args["tm_blk"], with_entry=False)
