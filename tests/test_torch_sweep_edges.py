"""The crafted edge cases of tests/test_torch_sweep_cases.py through the
JAX package's sweeps and the port's plain versions, on the CPU.

- The worklist's item sweep: JAX's `worklist._sweep_items` (intersector
  "exact") on the case's WorkList against `cuda_items.item_sweep_plain`,
  every item row.
- The kslots sweep: JAX's SWEEP + RESOLVE (`kslots._chunk_pipeline`,
  kslots.py:165-185: `_mt_sweep`, the slot mask, the min t / min id at that
  t reduce or the any) on the case's cid and n_slots tables against
  `cuda_kslots.kslot_sweep_plain`.

Cases: exact t ties across clusters of one item or slots of one row (the
smaller id wins, also from a later slot), a cluster named twice, slots
past n_cand / n_slots that name the nearest cluster C - 1, dead rays in
live items, overflowed kslots rays, n_items 0 and n_items = i_cap, an item
whose rays are all occluded by its first chunk; at S = 2, 16 and 96. hit,
tri and occlusion exact; t at rtol 1e-6 + atol 2e-6 (XLA's CPU code
contracts FMAs, eager torch does not; ROADMAP "Standing deviations").
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu.accel.traverse import _mt_sweep
from path_tracer_ai_tpu_torch.accel import cuda_items, cuda_kslots
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import T, T_TOL, _one_torch_thread  # noqa: F401

CPU_SIZES = (2, 16, 96)
I32_MAX = 2**31 - 1


def _jax_accel(case):
    """The fields of a ClusterAccel that the sweeps read."""
    return types.SimpleNamespace(
        v0=jnp.asarray(case["v0"]), e1=jnp.asarray(case["e1"]),
        e2=jnp.asarray(case["e2"]), tri_id=jnp.asarray(case["tri_id"]),
        cluster_size=case["v0"].shape[1])


def _assert_same(got, ref, want_tri):
    if want_tri:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   **T_TOL)
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("name", cases.ITEM_CASES)
def test_item_sweep_edges_match_jax(name, want_tri):
    for s in CPU_SIZES:
        case = cases.item_case(name, s)
        nb = case["ibase"].shape[0]
        wl = jworklist.WorkList(
            *(jnp.asarray(case[k]) for k in ("item_block", "ibase",
                                               "order_g", "n_cand")),
            jnp.zeros(nb, bool), jnp.int32(case["n_items"]))
        ref = jworklist._sweep_items(
            _jax_accel(case), wl, *(jnp.asarray(case[k]) for k in (
                "o_blk", "d_blk", "tm_blk")), case["t_min"], cases.G, 8,
            want_tri)
        got = cuda_items.item_sweep_plain(
            T(cases.pack(case)), T(cases.item_block_rays(case)),
            *(T(case[k]) for k in ("item_block", "ibase", "order_g",
                                   "n_cand")), case["n_items"], want_tri)
        _assert_same(got, ref, want_tri)
        res = got[want_tri and 1 or 0].numpy()
        if name == "no_items":  # every row as the wrapper leaves it
            assert (res == (I32_MAX if want_tri else False)).all()
        elif not want_tri:
            assert res.any() and not res.all()
        else:
            assert (res != I32_MAX).any()
        if want_tri and name == "ties":
            # the tie on clusters 0 and 1 goes to cluster 1's smaller ids,
            # in the slot before cluster 0 (block 0) and after it (block 1)
            ids = res[:case["n_items"]]
            c1 = (ids >= 100) & (ids < 100 + s)
            c0 = (ids >= 5 * s + 100) & (ids < 6 * s + 100)
            assert c1.any() and not c0.any()
        if name == "occluded_first_chunk" and not want_tri:
            assert res[:case["n_items"]].all()


def _jax_kslot_resolve(case, want_tri):
    """kslots.py:165-185 on the case's tables: the sweep of every slot,
    masked to the first n_slots, and the reduce."""
    c = jnp.asarray(case["cid"])
    r, k = c.shape
    s = case["v0"].shape[1]
    tt, ok = _mt_sweep(jnp.asarray(case["o"])[:, None],
                       jnp.asarray(case["d"])[:, None],
                       jnp.asarray(case["v0"])[c].reshape(r, -1, 3),
                       jnp.asarray(case["e1"])[c].reshape(r, -1, 3),
                       jnp.asarray(case["e2"])[c].reshape(r, -1, 3),
                       case["t_min"], jnp.asarray(case["tm"])[:, None])
    slot_live = jnp.arange(k)[None] < jnp.asarray(case["n_slots"])[:, None]
    ok = ok[:, 0] & jnp.repeat(slot_live, s, axis=1)
    tt = jnp.where(ok, tt[:, 0], jnp.inf)
    if not want_tri:
        return (jnp.any(ok, axis=1),)
    best = jnp.min(tt, axis=1)
    tri = jnp.asarray(case["tri_id"])[c].reshape(r, -1)
    return best, jnp.min(jnp.where(ok & (tt <= best[:, None]), tri, I32_MAX),
                         axis=1)


@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("name", cases.KSLOT_CASES)
def test_kslot_sweep_edges_match_jax(name, want_tri):
    for s in CPU_SIZES:
        case = cases.kslot_case(name, s)
        ref = _jax_kslot_resolve(case, want_tri)
        got = cuda_kslots.kslot_sweep_plain(
            T(cases.pack(case)), T(cases.kslot_rays(case)), T(case["cid"]),
            T(case["n_slots"]), want_tri)
        _assert_same(got, ref, want_tri)
        res = got[want_tri and 1 or 0].numpy()
        dead = case["tm"] < 0
        if want_tri:
            assert (res != I32_MAX).any() and (res[dead] == I32_MAX).all()
        else:
            assert res.any() and not res[dead].any()
        if want_tri and name == "ties":
            # rows 0 and 1 sweep both copies: cluster 1's ids win
            both = np.isin(np.arange(res.shape[0]) % 4, (0, 1))
            c0 = (res >= 5 * s + 100) & (res < 6 * s + 100)
            assert not c0[both].any() and ((res >= 100) & (res < 100 + s))[
                both].any()
        if name == "occluded_first_chunk" and not want_tri:
            assert res.all()
