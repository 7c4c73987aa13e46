"""The packet cascades' loop as the port runs it (traverse._cascade_stages:
static stages, each one call of accel.cuda_cascade.cascade_stage, the
stage's loop on the device) against the JAX package's `_cascade_traverse`
(traverse.py:439-520, its while_loop) and against the port's host-stepped
loop (traverse._cascade_traverse with a sweep an iteration, the loop the
card ran before the stage kernel), on the CPU, where the stage runs its
plain version.

The cases are tests/test_torch_sweep_cases.py's cascade cases (a stage
ending with exactly size // 2 blocks active, fewer than 64 blocks, blocks
with no candidate, all lanes dead, k carried over four stages, a closest
block that the entry rule retires while its stage runs on and whose later
group holds a nearer triangle on its box face, -0.0 / +0.0 ties), at groups
of 1, 2, 5 and 8 (5 and 8: C = 12 not a multiple), and the three queries
on a random soup. Occlusion, hit, tri and the block order exact; t bitwise
the host-stepped loop's and within rtol 1e-6 + atol 2e-6 of JAX's (XLA's
CPU code contracts FMAs, eager torch does not; ROADMAP §3); the final k
the host-stepped loop's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel.traverse import _mt_sweep
from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles, traverse
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)

I32_MAX = 2**31 - 1
S = 16
T_LANES = 16
JAX_G = (2, 5)


def _blocks(case, closest):
    blocks = (T(case["rays"]), T(case["order_g"]), T(case["n_cand"]))
    return blocks + (T(case["entry"]),) if closest else blocks


def _carry(nb, t_lanes, closest):
    if closest:
        return (torch.full((nb, t_lanes), np.inf, dtype=torch.float32),
                torch.full((nb, t_lanes), -1, dtype=torch.int32))
    return (torch.zeros((nb, t_lanes), dtype=torch.bool),)


def _stages(pack, blocks, carry, closest):
    """The port's loop: (carry, blk_index, final k, stage calls as (size,
    threshold, k in, k out, active at the end))."""
    calls = []

    def stage(b, c, k, thr):
        k_in = int(k)
        out = cuda_cascade.cascade_stage(
            pack, b[0], b[1], b[2], c, k, thr,
            **({"entry": b[3]} if closest else {}))
        calls.append((b[0].shape[0], thr, k_in, int(out[1]),
                      int(out[2].sum())))
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, stage)
    return carry, blk, calls[-1][3], calls


def _host_stepped(pack, blocks, carry, closest):
    """The host-stepped loop: _cascade_traverse (the same stages, each
    stepped on the host: one host read a vote), with the loop's rules
    written out as its active_fn and sweep_update, one tile_sweep (plain)
    an iteration; (carry, blk_index, final k)."""
    rays, order_g, n_cand = blocks[:3]
    g = order_g.shape[2]
    last = order_g.shape[1] - 1
    ks = []

    def active_fn(k, b, c):
        ks.append(k)
        tb, nc = b[0][:, 6], b[2]
        if not closest:
            return (k * g < nc) & ~(c[0] | (tb < 0.0)).all(dim=1)
        best_eff = torch.where(tb < 0.0, -np.inf, c[0])
        return ((k * g < nc)
                & (b[3][:, min(k, last) * g] <= best_eff.amax(dim=1)))

    def sweep_update(k, b, c, idx):
        cid = lambda sel: b[1][sel, min(k, last)]
        if not closest:
            occ = c[0].clone()
            r_act = b[0][idx]
            r_act[:, 6].masked_fill_(occ[idx], -1.0)
            _t, tri = cuda_ctiles.tile_sweep_plain(pack, r_act, cid(idx))
            occ[idx] |= tri != I32_MAX
            return (occ,)
        on = torch.nonzero(k * g < b[2]).squeeze(1)
        best_t, best_id = c[0].clone(), c[1].clone()
        bt = best_t[on]
        r_act = b[0][on]
        r_act[:, 6] = torch.minimum(r_act[:, 6], bt)
        ct, gid = cuda_ctiles.tile_sweep_plain(pack, r_act, cid(on),
                                               tie="slot")
        closer = ct < bt
        best_t[on] = torch.where(closer, ct, bt)
        best_id[on] = torch.where(closer, gid, best_id[on])
        return best_t, best_id

    carry, blk = traverse._cascade_traverse(blocks, carry, sweep_update,
                                            active_fn)
    return carry, blk, ks[-1]


def _jax(case, closest):
    """The JAX package's _cascade_traverse with any_hit_packets' or
    closest_hit_packets' active_fn and sweep_update (traverse.py:812-845,
    940-955) on the same blocks; (carry, blk_index) as numpy."""
    acc = types.SimpleNamespace(**{k: jnp.asarray(case[k]) for k in
                                   ("v0", "e1", "e2", "tri_id")})
    t_min = case["t_min"]
    order_g = jnp.asarray(case["order_g"])
    g = order_g.shape[2]
    max_k = order_g.shape[1] - 1
    nb, t_lanes = case["tm"].shape

    def gather(cid, size):
        return (acc.v0[cid].reshape(size, -1, 3),
                acc.e1[cid].reshape(size, -1, 3),
                acc.e2[cid].reshape(size, -1, 3))

    if not closest:
        def active_fn(k, blocks, carry):
            tb, nc = blocks[2], blocks[3]
            return (k * g < nc) & ~jnp.all(carry[0] | (tb < 0.0), axis=1)

        def sweep_update(k, blocks, carry):
            ob, db, tb, nc, ordg = blocks
            (occ,) = carry
            cid = ordg[:, jnp.minimum(k, max_k)]
            blk_on = (k * g < nc) & ~jnp.all(occ | (tb < 0.0), axis=1)
            _, ok = _mt_sweep(ob, db, *gather(cid, ob.shape[0]), t_min, tb)
            return (occ | (blk_on[:, None] & jnp.any(ok, axis=-1)),)

        blocks = (case["o"], case["d"], case["tm"], case["n_cand"],
                  case["order_g"])
        carry = (jnp.zeros((nb, t_lanes), bool),)
    else:
        def active_fn(k, blocks, carry):
            _, _, tb, nc, ent = blocks[:5]
            best_eff = jnp.where(tb < 0.0, -jnp.inf, carry[0])
            entry_k = ent[:, jnp.minimum(k, max_k) * g]
            return (k * g < nc) & (entry_k <= jnp.max(best_eff, axis=1))

        def sweep_update(k, blocks, carry):
            ob, db, tb, nc, ent, ordg = blocks
            best_t, best_id = carry
            size = ob.shape[0]
            cid = ordg[:, jnp.minimum(k, max_k)]
            blk_on = k * g < nc
            cti = acc.tri_id[cid].reshape(size, -1)
            t, _ = _mt_sweep(ob, db, *gather(cid, size), t_min,
                             jnp.minimum(tb, best_t))
            ct = jnp.min(t, axis=-1)
            gid = jnp.take_along_axis(cti, jnp.argmin(t, axis=-1), axis=1)
            closer = blk_on[:, None] & (ct < best_t)
            return (jnp.where(closer, ct, best_t),
                    jnp.where(closer, gid, best_id))

        blocks = (case["o"], case["d"], case["tm"], case["n_cand"],
                  case["entry"], case["order_g"])
        carry = (jnp.full((nb, t_lanes), jnp.inf, jnp.float32),
                 jnp.full((nb, t_lanes), -1, jnp.int32))

    @jax.jit
    def run(blocks, carry):
        return jtraverse._cascade_traverse(blocks, carry, sweep_update,
                                           active_fn)

    carry, blk = run(tuple(jnp.asarray(b) for b in blocks), carry)
    return tuple(np.asarray(c) for c in carry), np.asarray(blk)


def _assert_same(got, want, closest, exact_t=True):
    np.testing.assert_array_equal(np.asarray(got[-1]), np.asarray(want[-1]))
    if not closest:
        np.testing.assert_array_equal(np.asarray(got[0][0]),
                                      np.asarray(want[0][0]))
        return
    t_g, t_w = np.asarray(got[0][0]), np.asarray(want[0][0])
    np.testing.assert_array_equal(np.asarray(got[0][1]),
                                  np.asarray(want[0][1]))
    np.testing.assert_array_equal(np.isfinite(t_g), np.isfinite(t_w))
    if exact_t:
        np.testing.assert_array_equal(t_g.view(np.int32), t_w.view(np.int32))
    else:
        np.testing.assert_allclose(t_g, t_w, **T_TOL)


def _run(name, g, closest, t_lanes=T_LANES):
    case = cases.cascade_case(name, S, t_lanes, g)
    pack = T(cases.pack(case))
    nb = case["rays"].shape[0]
    blocks = _blocks(case, closest)
    got = _stages(pack, blocks, _carry(nb, t_lanes, closest), closest)
    host = _host_stepped(pack, blocks, _carry(nb, t_lanes, closest),
                         closest)
    return case, got, host


def _case_facts(name, case, got, closest, g):
    """What each crafted case is there to show happened."""
    carry, _blk, k, calls = got
    out = carry[1] if closest else carry[0]
    if name == "half_active":
        size, thr, _, _, n_act = calls[0]
        assert (size, thr, n_act) == (128, 64, 64)
    if name == "small_nb":
        assert len(calls) == 1 and calls[0][1] == 0
    if name == "all_dead":
        assert k == 0
        assert not ((out >= 0).any() if closest else out.any())
    if name == "carried_k":
        assert len(calls) == 4 and calls[-1][2] > 0
    if name == "no_candidates":
        assert (case["n_cand"][::3] == 0).all()
    if name == "retired_face" and closest:
        # a retired block swept on: cluster 11's nearer hits replaced
        # cluster 0's
        s11 = (out >= 100 + 11 * S) & (out < 100 + 12 * S)
        assert s11.any()
    if name == "signed_zero" and closest:
        t = carry[0].numpy()
        zero = t == 0.0
        assert np.signbit(t[zero]).any() and (~np.signbit(t[zero])).any()


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", cases.CASCADE_G)
@pytest.mark.parametrize("name", cases.CASCADE_CASES)
def test_stages_match_the_host_stepped_loop(name, g, closest):
    """Every crafted cascade, both folds: the port's stages give the
    host-stepped loop's bits (carry, block order) and its final k."""
    case, got, host = _run(name, g, closest)
    _assert_same(got[:2], host[:2], closest)
    assert got[2] == host[2]
    _case_facts(name, case, got, closest, g)


@pytest.mark.parametrize("g", JAX_G)
@pytest.mark.parametrize("name", cases.CASCADE_CASES)
def test_stages_match_jax(name, g):
    """Every crafted cascade at g 2 and 5 against the JAX package's
    _cascade_traverse, any hit and closest: occlusion, tri and the block
    order exact, t within T_TOL."""
    for closest in (False, True):
        case, got, _host = _run(name, g, closest)
        want = _jax(case, closest)
        _assert_same(got[:2], want, closest, exact_t=False)


def test_stage_at_one_lane():
    """Blocks of one lane (T 1, the generic instance's shape on the card):
    the host-stepped loop's bits and k."""
    for closest in (False, True):
        _case, got, host = _run("carried_k", 2, closest, t_lanes=1)
        _assert_same(got[:2], host[:2], closest)
        assert got[2] == host[2]


def _host_stepped_queries(monkeypatch):
    """Patches _cascade_stages to the host-stepped loop; returns the final
    k of each cascade run while patched."""
    ks = []
    real = traverse._cascade_stages

    def stepped(block_arrays, carry, stage, min_blocks=32):
        closest = len(block_arrays) == 4
        # _cascade_traverse runs its stages through the real skeleton
        monkeypatch.setattr(traverse, "_cascade_stages", real)
        try:
            got = _host_stepped(stepped.pack, block_arrays, carry, closest)
        finally:
            monkeypatch.setattr(traverse, "_cascade_stages", stepped)
        ks.append(got[2])
        return got[:2]

    monkeypatch.setattr(traverse, "_cascade_stages", stepped)
    return stepped, ks


@pytest.mark.parametrize("query", ["any", "any_exact", "closest"])
@pytest.mark.parametrize("block_size,g", [(16, 2), (32, 5), (8, 8)])
def test_queries_match_jax_and_the_host_stepped_loop(rng, monkeypatch, query,
                                                     block_size, g):
    """any_hit_packets (conservative and exact cull) and
    closest_hit_packets on a random soup (dead rays, per-ray and infinite
    t_max): JAX's results, and the host-stepped loop's bits and final k.
    JAX runs eagerly (jax.disable_jit), as the port computes: under jit
    XLA contracts FMAs, which at (32, 5) moves the t of a ray grazing a
    near-degenerate triangle by 1e-5 relative (1.5756462 against eager
    JAX's 1.5756621, the port's bits)."""
    ja, pa, _ = _scene(rng, 700, S)
    n = block_size * 40
    o, d, tm = _rays(rng, n)
    tm[1::5] = np.inf
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), 1e-3, T(tm))
    kw = dict(block_size=block_size, group_size=g)
    if query == "any_exact":
        kw["exact_cull"] = 4
    fn, jfn = ((traverse.closest_hit_packets, jtraverse.closest_hit_packets)
               if query == "closest" else
               (traverse.any_hit_packets, jtraverse.any_hit_packets))
    ks = []
    real = cuda_cascade.cascade_stage

    def spy(*a, **k_):
        out = real(*a, **k_)
        ks.append(int(out[1]))
        return out

    monkeypatch.setattr(cuda_cascade, "cascade_stage", spy)
    got = fn(*args_t, **kw)
    with jax.disable_jit():
        want = jfn(*args_j, **kw)
    monkeypatch.setattr(cuda_cascade, "cascade_stage", real)
    stepped, ks_host = _host_stepped_queries(monkeypatch)
    stepped.pack = cuda_ctiles.pack_tris(pa)
    host = fn(*args_t, **kw)
    assert ks[-1] == ks_host[-1]
    if query == "closest":
        assert np.asarray(want.hit).mean() > 0.03
        for x, y in zip(got, host):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   **T_TOL)
    else:
        assert 0.03 < np.asarray(want).mean() < 0.97
        np.testing.assert_array_equal(got.numpy(), host.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
