"""The perray queries' loop as the port runs it (traverse._cascade_stages,
min_blocks 1024: static stages, each one call of
accel.cuda_cascade.perray_stage, on the card one launch of the stage
kernel) on the CPU, where the stage runs its plain version, against:

- the host-stepped loop that `closest_hit_perray` / `any_hit_perray` ran
  before (traverse._cascade_traverse with their active_fn and
  sweep_update as they were, written out below: one kslot_sweep call an
  iteration on the active rays, every slot of the group): carry, act and
  k bitwise at every stage;
- the JAX package's `_cascade_traverse` run eagerly (jax.disable_jit)
  with `closest_hit_perray`'s / `any_hit_perray`'s active_fn and
  sweep_update (traverse.py:648-665, 727-738), at S 2 and groups of 1 and
  8 (eager JAX compiles each operation anew at each shape, seconds a
  shape): the same stages, act and k, occlusion and tri exact, t bitwise
  (eager XLA does not contract FMAs); the two queries under jit within
  rtol 1e-6 + atol 2e-6 of t, as tests/test_torch_perray.py holds them;
- brute force (engine.intersect on the soup; every triangle of the
  crafted clusters through kslot_sweep's plain version, whose arithmetic
  reads their own e1 and e2): occlusion, hit and t bitwise.

The crafted cascades are tests/test_torch_sweep_cases.py's perray cases
(dead rays and t_max -0.0, +0.0, NaN; rays with no candidate; rays that
run out of candidates at every k; an exact tie across groups that the
first group keeps; a hit reachable only through a filler id past n_cand;
cap > C, whose columns past C hold cluster 0; ties of -0.0 and +0.0), at
groups of 1, 4 and 8 and clusters of 2 and 128 triangles; the two rules
alone against JAX's active_fn; the two queries on the crafted clusters
with cap below the busiest rays' counts (overflow to the packet fallback)
and above C; and on a random soup.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel.clusters import ClusterAccel as JAccel
from path_tracer_ai_tpu.accel.traverse import _mt_sweep
from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_kslots, traverse
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)

MIN_BLOCKS = cases.PERRAY_MIN_BLOCKS
JAX_S = 2
JAX_G = (1, 8)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _carry(n, closest):
    if closest:
        return (torch.full((n, 1), np.inf, dtype=torch.float32),
                torch.full((n, 1), -1, dtype=torch.int32))
    return (torch.zeros((n, 1), dtype=torch.bool),)


def _blocks(case):
    return (T(case["rays"]), T(case["order_g"]), T(case["n_cand"]))


def _geo(case):
    return types.SimpleNamespace(
        v0=T(case["v0"]), e1=T(case["e1"]), e2=T(case["e2"]),
        tri_id=T(case["tri_id"]), cluster_size=case["v0"].shape[1])


def _record(stages, size, thr, k_in, k_out, act, carry):
    stages.append((size, thr, k_in, k_out, np.asarray(act).copy(),
                   tuple(np.asarray(c).copy() for c in carry)))


# ---- the three loops of one crafted cascade -------------------------------

def _port(case, closest, stage):
    """The port's loop, stage(blocks, carry, k, threshold) a stage:
    (carry, blk_index, stages as (size, threshold, k in, k out, act,
    carry))."""
    stages = []

    def run(b, c, k, thr):
        k_in = int(k)
        out = stage(b, c, k, thr)
        _record(stages, b[0].shape[0], thr, k_in, int(out[1]), out[2],
                out[0])
        return out

    carry, blk = traverse._cascade_stages(
        _blocks(case), _carry(len(case["n_cand"]), closest), run,
        min_blocks=MIN_BLOCKS)
    return carry, blk, stages


def _wrapper_stage(case):
    pack = T(cases.pack(case))
    return lambda b, c, k, thr: cuda_cascade.perray_stage(
        pack, b[0], b[1], b[2], c, k, thr)


def _cpu_route_stage(case, closest):
    """The stage as traverse builds it on the CPU (its eager sweeps)."""
    stage, _pack = traverse._perray_stage(
        _geo(case), case["order_g"].shape[2], None, case["t_min"],
        not closest, torch.device("cpu"))
    return stage


def _before(case, closest, monkeypatch):
    """The host-stepped loop of before: _cascade_traverse with the perray
    queries' blocks (o, d [n, 1, 3], t_max [n, 1], n_cand, order_g),
    active_fn and sweep_update as they were (kslot_sweep an iteration on
    the active rays, n_slots = g); stages recorded as _port's."""
    pack = T(cases.pack(case))
    n, kgroups, g = case["order_g"].shape
    max_k = kgroups - 1
    t_min = case["t_min"]

    def sweep(ob, db, tb, cid, closest):
        n_slots = torch.full((cid.shape[0],), g, dtype=torch.int32)
        rays = cuda_kslots.pack_rays(ob[:, 0], db[:, 0], tb[:, 0], t_min)
        if closest:
            return cuda_kslots.kslot_sweep(pack, rays, cid, n_slots, True,
                                           tie="slot")
        return cuda_kslots.kslot_sweep(pack, rays, cid, n_slots, False)

    if closest:
        def active_fn(k, blocks, carry):
            tb, nc = blocks[2], blocks[3]
            return (k * g < nc) & (tb[:, 0] >= 0.0)

        def sweep_update(k, blocks, carry, idx):
            ob, db, tb, _nc, ordg = blocks
            best_t, best_id = (a.clone() for a in carry)
            bt = best_t[idx]
            cap_t = torch.minimum(tb[idx], bt)
            ct, gid = sweep(ob[idx], db[idx], cap_t, ordg[idx, min(k, max_k)],
                            True)
            ct, gid = ct[:, None], gid[:, None]
            closer = ct < bt
            best_t[idx] = torch.where(closer, ct, bt)
            best_id[idx] = torch.where(closer, gid, best_id[idx])
            return best_t, best_id
    else:
        def active_fn(k, blocks, carry):
            return (k * g < blocks[3]) & ~carry[0][:, 0]

        def sweep_update(k, blocks, carry, idx):
            ob, db, tb, _nc, ordg = blocks
            occ = carry[0].clone()
            (hit,) = sweep(ob[idx], db[idx], tb[idx],
                           ordg[idx, min(k, max_k)], False)
            occ[idx] |= hit[:, None]
            return (occ,)

    stages = []
    real = traverse._stepped_stage

    def spy(blocks, carry, k, threshold, su, af, votes=None):
        cur, k_out, act = real(blocks, carry, k, threshold, su, af, votes)
        _record(stages, blocks[0].shape[0], threshold, k, k_out, act, cur)
        return cur, k_out, act

    blocks = (T(case["o"])[:, None], T(case["d"])[:, None],
              T(case["tm"])[:, None], T(case["n_cand"]), T(case["order_g"]))
    with monkeypatch.context() as m:
        m.setattr(traverse, "_stepped_stage", spy)
        carry, blk = traverse._cascade_traverse(
            blocks, _carry(n, closest), sweep_update, active_fn,
            min_blocks=MIN_BLOCKS)
    return carry, blk, stages


def _jax(case, closest, monkeypatch):
    """The JAX package's _cascade_traverse, run eagerly, with
    closest_hit_perray's or any_hit_perray's active_fn and sweep_update
    (traverse.py:648-665, 727-738) on the same one-ray blocks; stages
    recorded as _port's (each jax.lax.while_loop call is one)."""
    acc = types.SimpleNamespace(**{k: jnp.asarray(case[k]) for k in
                                   ("v0", "e1", "e2", "tri_id")})
    n, kgroups, g = case["order_g"].shape
    max_k = kgroups - 1
    t_min = case["t_min"]
    acts = []

    def gather(cid, size):
        return (acc.v0[cid].reshape(size, -1, 3),
                acc.e1[cid].reshape(size, -1, 3),
                acc.e2[cid].reshape(size, -1, 3))

    if closest:
        def active_fn(k, blocks, carry):
            _, _, tb, nc = blocks[:4]
            act = (k * g < nc) & (tb[:, 0] >= 0.0)
            acts.append(act)
            return act

        def sweep_update(k, blocks, carry):
            ob, db, tb, nc, ordg = blocks
            best_t, best_id = carry
            size = ob.shape[0]
            cid = ordg[:, jnp.minimum(k, max_k)]
            on = k * g < nc
            cti = acc.tri_id[cid].reshape(size, -1)
            t, _ = _mt_sweep(ob, db, *gather(cid, size), t_min,
                             jnp.minimum(tb, best_t))
            ct = jnp.min(t, axis=-1)
            gid = jnp.take_along_axis(cti, jnp.argmin(t, axis=-1), axis=1)
            closer = on[:, None] & (ct < best_t)
            return (jnp.where(closer, ct, best_t),
                    jnp.where(closer, gid, best_id))

        carry = (jnp.full((n, 1), jnp.inf, jnp.float32),
                 jnp.full((n, 1), -1, jnp.int32))
    else:
        def active_fn(k, blocks, carry):
            act = (k * g < blocks[3]) & ~carry[0][:, 0]
            acts.append(act)
            return act

        def sweep_update(k, blocks, carry):
            ob, db, tb, nc, ordg = blocks
            (occ,) = carry
            size = ob.shape[0]
            cid = ordg[:, jnp.minimum(k, max_k)]
            on = (k * g < nc) & ~occ[:, 0]
            _, ok = _mt_sweep(ob, db, *gather(cid, size), t_min, tb)
            return (occ | (on[:, None] & jnp.any(ok, axis=-1)),)

        carry = (jnp.zeros((n, 1), bool),)

    stages = []
    real = jax.lax.while_loop

    def loop(cond, body, init):
        out = real(cond, body, init)
        _record(stages, init[1].shape[0], None, int(init[0]), int(out[0]),
                acts[-1], out[1:])
        return out

    blocks = (case["o"][:, None], case["d"][:, None], case["tm"][:, None],
              case["n_cand"], case["order_g"])
    with jax.disable_jit(), monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", loop)
        carry, blk = jtraverse._cascade_traverse(
            tuple(jnp.asarray(b) for b in blocks), carry, sweep_update,
            active_fn, min_blocks=MIN_BLOCKS)
    return carry, blk, stages


def _same(got, want, thresholds=True):
    """Carry and block order bitwise, and every stage's size, k in and
    out, act and carry."""
    for x, y in zip(got[0], want[0]):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert a[0] == b[0] and a[2:4] == b[2:4]
        if thresholds:
            assert a[1] == b[1]
        np.testing.assert_array_equal(a[4], b[4])
        for x, y in zip(a[5], b[5]):
            np.testing.assert_array_equal(_bits(x), _bits(y))


def _case_facts(name, case, got, closest, g):
    """What each crafted case is there to show happened."""
    carry, blk, stages = got
    out = _unpermute(carry, blk)
    assert len(stages) == 4 and stages[-1][1] == 0
    if name == "dead_and_zero" and closest:
        assert np.isinf(out[0][~(case["tm"] >= 0)]).all()
    if name == "dead_and_zero" and not closest:
        assert not out[0][~(case["tm"] >= case["t_min"])].any()
    if name == "exhausted":
        assert stages[-1][2] > 0
    if name == "group_ties" and closest:
        # the first group's cluster keeps the tie: 0 (ids 100 + j) on the
        # even rays, its copy 12 (ids j) on the odd ones
        n = len(out[1])
        (_t, tri0) = cuda_kslots.kslot_sweep(
            T(cases.pack(case)), T(case["rays"][:, :, 0]),
            torch.zeros((n, 1), dtype=torch.int32),
            torch.ones(n, dtype=torch.int32), True, tie="slot")
        want = tri0.numpy() - 100 * (np.arange(n) % 2)
        np.testing.assert_array_equal(out[1], want)
    if name == "filler_hit" and g > 1 and closest:
        # hits from the filler past n_cand (cluster 12, ids j < S)
        s = case["v0"].shape[1]
        assert ((out[1] >= 0) & (out[1] < s)).any()
    if name == "signed_zero" and closest:
        t = out[0]
        zero = t == 0.0
        assert np.signbit(t[zero]).any() and (~np.signbit(t[zero])).any()


def _unpermute(carry, blk):
    blk = np.asarray(blk)
    out = []
    for c in carry:
        c = np.asarray(c)[:, 0]
        x = np.empty_like(c)
        x[blk] = c
        out.append(x)
    return out


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", cases.PERRAY_G)
@pytest.mark.parametrize("s", cases.PERRAY_S)
@pytest.mark.parametrize("name", cases.PERRAY_CASES)
def test_stages_match_the_host_stepped_loop(monkeypatch, name, s, g,
                                            closest):
    """Every crafted perray cascade, both folds: the stage as the port runs
    it on the CPU (its eager sweeps) and through perray_stage (the plain
    version's default sweep, kslot_sweep's plain version) give, at every
    stage, the host-stepped loop's carry, act and k."""
    case = cases.perray_case(name, s, g)
    got = _port(case, closest, _cpu_route_stage(case, closest))
    _same(got, _port(case, closest, _wrapper_stage(case)))
    _same(got, _before(case, closest, monkeypatch))
    _case_facts(name, case, got, closest, g)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", JAX_G)
@pytest.mark.parametrize("name", cases.PERRAY_CASES)
def test_stages_match_jax(monkeypatch, name, g, closest):
    """Every crafted perray cascade at S 2, groups of 1 and 8 (eager JAX
    compiles each operation anew at each shape, seconds a shape), both
    folds: at every stage JAX's act, k and carry, t bitwise."""
    case = cases.perray_case(name, JAX_S, g)
    got = _port(case, closest, _cpu_route_stage(case, closest))
    _same(got, _jax(case, closest, monkeypatch), thresholds=False)


def test_rules_are_jax_active_fn():
    """One vote of each fold (a threshold no count exceeds, so the stage
    sweeps nothing) at k 0-3 on crafted rays: act is JAX's active_fn
    (closest: k g < n_cand & t_max >= 0; any hit: k g < n_cand & not
    occluded) with dead, NaN, +0.0 and -0.0 t_max, rays out of candidates
    and with none; k is left as it came."""
    g = 4
    case = cases.perray_case("dead_and_zero", 16, g)
    n = len(case["n_cand"])
    n_cand = case["n_cand"].copy()
    n_cand[::5] = 0
    case["n_cand"] = n_cand
    occ = np.zeros(n, bool)
    occ[::3] = True
    pack = T(cases.pack(case))
    for k in range(4):
        for closest in (False, True):
            carry = _carry(n, closest)
            if not closest:
                carry[0][:, 0] = T(occ)
            k_t = torch.tensor([k], dtype=torch.int32)
            _c, k_out, act = cuda_cascade.perray_stage(
                pack, T(case["rays"]), T(case["order_g"]), T(n_cand), carry,
                k_t, n)
            nc, tb = jnp.asarray(n_cand), jnp.asarray(case["tm"])
            want = ((k * g < nc) & (tb >= 0.0) if closest
                    else (k * g < nc) & ~jnp.asarray(occ))
            np.testing.assert_array_equal(act.numpy(), np.asarray(want))
            assert int(k_out) == k
    assert {float(x) for x in case["tm"][1:3]} == {0.0}


# ---- the queries -----------------------------------------------------------

def _crafted_accel(s):
    """fused_clusters' geometry as the two packages' accels (the supers
    one box holding all 13 clusters) and its triangles."""
    geo = cases.fused_clusters(s)
    bmin, bmax = geo["bmin"], geo["bmax"]
    lo, hi = bmin.min(0), bmax.max(0)
    big = np.float32(3.0e37)
    cbmin = np.full((1, 16, 3), big, np.float32)
    cbmax = np.full((1, 16, 3), -big, np.float32)
    cbmin[0, :len(bmin)], cbmax[0, :len(bmin)] = bmin, bmax
    arrays = (bmin, bmax, geo["v0"], geo["e1"], geo["e2"], geo["tri_id"],
              lo, hi, lo[None], hi[None], cbmin, cbmax)
    ja = JAccel(*(jnp.asarray(x) for x in arrays))
    pa = accel_from_numpy(*arrays, device="cpu")
    pack = T(cases.pack(geo))
    c_n = len(bmin)

    def brute(o, d, t_min, tm):
        # every triangle, with the clusters' own e1 and e2 (v0 + e1 - v0
        # is not e1 in f32): (min t, occluded)
        n = o.shape[0]
        rays = cuda_kslots.pack_rays(o, d, tm, t_min)
        cid = torch.arange(c_n, dtype=torch.int32).expand(n, c_n)
        n_slots = torch.full((n,), c_n, dtype=torch.int32)
        t, _tri = cuda_kslots.kslot_sweep(pack, rays, cid, n_slots, True)
        (occ,) = cuda_kslots.kslot_sweep(pack, rays, cid, n_slots, False)
        return t, occ

    return ja, pa, brute


def _kernel_route(monkeypatch):
    """The queries' stages through cuda_cascade.perray_stage, as on the
    card (its plain version on the CPU)."""
    monkeypatch.setattr(traverse, "_kernel_sweeps", lambda dev: True)


def _check_queries(monkeypatch, ja, pa, brute, o, d, tm, t_min, kw):
    """Both queries: JAX (jit) hit, tri and occlusion exact, t within
    T_TOL; brute force (o, d, t_min, t_max) -> (t, occluded) t and
    occlusion bitwise; the kernel route's
    bits and final k those of the CPU route and of the host-stepped loop
    of before (perray_stage_plain sweeping through kslot_sweep)."""
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), t_min, T(tm))
    hj = jtraverse.closest_hit_perray(*args_j, **kw)
    ht = traverse.closest_hit_perray(*args_t, **kw)
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf_t, bf_occ = brute(*args_t[1:])
    np.testing.assert_array_equal(_bits(ht.t.numpy()), _bits(bf_t.numpy()))
    occ_j = np.asarray(jtraverse.any_hit_perray(*args_j, **kw))
    occ_t = traverse.any_hit_perray(*args_t, **kw)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(occ_t.numpy(), bf_occ.numpy())

    ks = {}
    real = cuda_cascade.perray_stage_plain

    def spy(*a, **k_):
        out = real(*a, **k_)
        ks.setdefault(ks.get("_run"), []).append(int(out[1]))
        return out

    monkeypatch.setattr(cuda_cascade, "perray_stage_plain", spy)
    runs = {}
    for run in ("cpu", "kernel"):
        ks["_run"] = run
        if run == "kernel":
            _kernel_route(monkeypatch)
        runs[run] = (traverse.closest_hit_perray(*args_t, **kw),
                     traverse.any_hit_perray(*args_t, **kw))
    for a, b in zip(runs["kernel"][0], runs["cpu"][0]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    np.testing.assert_array_equal(runs["kernel"][1].numpy(),
                                  runs["cpu"][1].numpy())
    assert ks["kernel"] == ks["cpu"] and len(ks["cpu"]) >= 2
    return ht, occ_t


@pytest.mark.parametrize("cap,g", [(4, 1), (4, 4), (16, 8)])
def test_queries_on_the_crafted_clusters(rng, monkeypatch, cap, g):
    """closest_hit_perray and any_hit_perray on the crafted clusters (C =
    13, cluster 12 cluster 0's copy with smaller ids), 2,048 rays from z =
    -2 (a quarter dead, some short of every plane): cap 4, below the
    busiest rays' counts (they overflow to the packet fallback), and cap
    16, past C (columns past C hold cluster 0)."""
    ja, pa, brute = _crafted_accel(16)
    n = 2048
    o, d, tm = cases._rays(rng, n, 16)
    o[:, :2] = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    tm[::4] = -1.0
    tm[1::9] = 0.5
    kw = dict(cap=cap, group_size=g, fallback_block=32)
    overflow = traverse._perray_candidates(pa, T(o), T(d), 1e-3, T(tm),
                                           cap)[3]
    assert overflow.any() == (cap < 13)
    ht, occ = _check_queries(monkeypatch, ja, pa, brute, o, d, tm, 1e-3, kw)
    assert 0.1 < ht.hit.float().mean() < 0.9
    assert torch.equal(occ, ht.hit)


@pytest.mark.parametrize("kw", [dict(), dict(cap=6, group_size=3),
                                dict(group_size=8)])
def test_queries_on_a_soup(rng, monkeypatch, kw):
    """The two queries on a random soup (dead rays, per-ray and infinite
    t_max; 2,304 rays, so that the cascade has two stages at min_blocks
    1024), with the tolerances of tests/test_torch_perray.py."""
    ja, pa, tris = _scene(rng, 600, 16)
    o, d, tm = _rays(rng, 2304)
    tm[1::5] = np.inf

    def brute(*args):
        return (intersect.closest_hit(tris, *args).t,
                intersect.any_hit(tris, *args))

    ht, _occ = _check_queries(monkeypatch, ja, pa, brute, o, d, tm, 1e-3,
                              dict(fallback_block=32, **kw))
    assert ht.hit.float().mean() > 0.03
