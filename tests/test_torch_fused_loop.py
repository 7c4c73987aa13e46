"""The fused cascades' loop as the port runs it (traverse._cascade_stages:
static stages, each one call of accel.cuda_cascade.fused_stage, on the
card one launch of the stage kernel) on the CPU, where the stage runs its
plain version, against:

- the host-stepped loop that `any_hit_fused` / `closest_hit_fused` ran
  before (traverse._cascade_traverse with their active_fn and sweep_update,
  a block_anyhit / block_closest call an iteration on the active blocks):
  carry, final k and act bitwise at every stage, on every case but the one
  where its sweep set differs (below);
- the JAX package's `any_hit_fused` / `closest_hit_fused` (Pallas kernels
  in interpret mode, as tests/test_torch_fused.py runs them): occlusion and
  tri exact, t within rtol 1e-6 + atol 2e-6 (XLA's CPU code contracts
  FMAs, eager torch does not);
- brute force: engine.intersect on the random soups, and on the crafted
  cascades the lexicographic (t, least id) minimum (any hit: the OR) over
  the triangles of the groups a block had swept by the stage's end, with
  the sweeps' own arithmetic (cuda_ctiles.mt_sweep_rows): bitwise.

The cases: random soups at tests/test_torch_fused.py's sizes with
early_skip / sub_skip on and off, sort on and off and exact_cull=16, an
all-dead wave, and tests/test_torch_sweep_cases.py's fused cascades (a
stage that ends with exactly size // 2 blocks active, fewer than 64
blocks, blocks with no candidate, all lanes dead, k carried over four
stages, blocks that run out of candidates while others go on, a block that
the entry rule retires while its stage runs on and whose later group holds
a nearer triangle or an exact tie with a smaller id, ties of -0.0 and
+0.0), an id out of range, which raises ValueError, and the crafted scene
`fused_tie_scene`, on which the closest cascade's sweep set decides an
exact tie with the port's own cull: the JAX package's set (every block with
k 8 < n_cand, which the port now sweeps) finds the smaller id, as brute
force does; the active blocks alone, the set of before, did not. Last, the
closest sweep's sub_skip gate keeps exact ties on box faces whether a
block or each 32 of its lanes vote (the kernel's width), as the ungated
sweep does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import pallas_anyhit as janyhit
from path_tracer_ai_tpu.accel import pallas_closest as jclosest
from path_tracer_ai_tpu.accel.clusters import ClusterAccel as JAccel
from path_tracer_ai_tpu_torch.accel import (
    cuda_anyhit,
    cuda_cascade,
    cuda_closest,
    cuda_ctiles,
    traverse,
)
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    combine_min_tri,
    pack_rays_tiles,
)
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_fused import T, T_TOL, _scene, _wave
from tests.test_torch_worklist import _one_torch_thread  # noqa: F401

I32_MAX = cuda_ctiles.I32_MAX
GROUP = cuda_anyhit.GROUP
S = 16


@pytest.fixture
def rng():
    return np.random.default_rng(17)


# ---- the host-stepped loop of before --------------------------------------

def _before_any_rules(tri_pack, max_k, early_skip, sub_skip, kernel_chunk):
    """any_hit_fused's active_fn and sweep_update as they were."""
    def active_fn(k, blocks, carry):
        rays, nc = blocks[:2]
        resolved = carry[0] | (rays[:, 6, :] < 0.0)
        return (k * GROUP < nc) & ~resolved.all(dim=1)

    def sweep_update(k, blocks, carry, idx):
        rays, _nc, ordg = blocks
        (occ,) = carry
        cid8 = ordg[idx, min(k, max_k)]
        r_act = rays[idx]
        for lo in range(0, idx.numel(), kernel_chunk):
            hi = lo + kernel_chunk
            hit = cuda_anyhit.block_anyhit(
                tri_pack, r_act[lo:hi], cid8[lo:hi].reshape(-1),
                early_skip=early_skip, sub_skip=sub_skip)
            occ[idx[lo:hi]] |= hit
        return (occ,)

    return active_fn, sweep_update


def _before_closest_rules(tri_pack, max_k, sub_skip, kernel_chunk):
    """closest_hit_fused's active_fn and sweep_update as they were: the
    sweep set is the ACTIVE blocks (idx)."""
    def active_fn(k, blocks, carry):
        rays, nc, ent, _ordg = blocks
        best_eff = torch.where(rays[:, 6, :] < 0.0, -np.inf, carry[0])
        return ((k * GROUP < nc)
                & (ent[:, min(k, max_k) * GROUP] <= best_eff.amax(dim=1)))

    def sweep_update(k, blocks, carry, idx):
        rays, _nc, _ent, ordg = blocks
        best_t, best_id = carry
        cid8 = ordg[idx, min(k, max_k)]
        rp = rays[idx]
        rp[:, 6, :] = torch.minimum(rp[:, 6, :], best_t[idx])
        for lo in range(0, idx.numel(), kernel_chunk):
            sl = idx[lo:lo + kernel_chunk]
            kt, ktri = cuda_closest.block_closest(
                tri_pack, rp[lo:lo + kernel_chunk],
                cid8[lo:lo + kernel_chunk].reshape(-1), sub_skip=sub_skip)
            best_t[sl], best_id[sl] = combine_min_tri(best_t[sl],
                                                      best_id[sl], kt, ktri)
        return best_t, best_id

    return active_fn, sweep_update


def _before_rules(pack, blocks, closest, kw):
    max_k = blocks[-1].shape[1] - 1
    chunk = kw.get("kernel_chunk", 8192)
    if closest:
        return _before_closest_rules(pack, max_k, kw.get("sub_skip", True),
                                     chunk)
    return _before_any_rules(pack, max_k, kw.get("early_skip", False),
                             kw.get("sub_skip", False), chunk)


def _record_before(monkeypatch, fn):
    """fn() with every stage of _cascade_traverse recorded: [(size,
    threshold, k in, k out, act, carry)]."""
    calls = []
    real = traverse._stepped_stage

    def spy(blocks, carry, k, threshold, sweep_update, active_fn,
            votes=None):
        cur, k_out, act = real(blocks, carry, k, threshold, sweep_update,
                               active_fn, votes)
        calls.append((blocks[0].shape[0], threshold, k, k_out, act.clone(),
                      tuple(c.clone() for c in cur)))
        return cur, k_out, act

    with monkeypatch.context() as m:
        m.setattr(traverse, "_stepped_stage", spy)
        out = fn()
    return out, calls


def _record_now(monkeypatch, fn):
    """fn() with every fused_stage call recorded as _record_before does."""
    calls = []
    real = cuda_cascade.fused_stage

    def spy(tri_pack, rays, order_g, n_cand, carry, k, threshold, **kw):
        k_in = int(k)
        out = real(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                   **kw)
        calls.append((rays.shape[0], threshold, k_in, int(out[1]),
                      out[2].clone(), tuple(c.clone() for c in out[0])))
        return out

    with monkeypatch.context() as m:
        m.setattr(cuda_cascade, "fused_stage", spy)
        out = fn()
    return out, calls


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_stages(now, before):
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert a[:4] == b[:4]
        assert torch.equal(a[4], b[4])
        for x, y in zip(a[5], b[5]):
            assert torch.equal(_bits(x), _bits(y))


# ---- the crafted cascades: one stage function at a time -------------------

def _case_inputs(case):
    geo = {k: case[k] for k in ("v0", "e1", "e2", "tri_id")}
    bb = np.zeros((1, 3), np.float32)
    acc = accel_from_numpy(case["bmin"], case["bmax"], *geo.values(),
                           bb[0], bb[0], bb, bb, bb[None], bb[None],
                           device="cpu")
    pack = cuda_anyhit.pack_tris_dummy(acc)
    return pack, (T(case["rays"]), T(case["n_cand"]), T(case["order_g"]))


def _case_carry(case, closest):
    nb, t_lanes = case["tm"].shape
    if closest:
        return (torch.full((nb, t_lanes), np.inf),
                torch.full((nb, t_lanes), I32_MAX, dtype=torch.int32))
    return (torch.zeros((nb, t_lanes), dtype=torch.bool),)


def _run_now(pack, blocks, carry, closest, kw):
    def stage(b, c, k, thr):
        if closest:
            return cuda_cascade.fused_stage(pack, b[0], b[3], b[1], c, k, thr,
                                            entry=b[2], **kw)
        return cuda_cascade.fused_stage(pack, b[0], b[2], b[1], c, k, thr,
                                        **kw)

    return traverse._cascade_stages(blocks, carry, stage)


def _brute_blocks(case, pack, k_end, closest):
    """Each block's lanes against the triangles of its candidates in the
    groups swept by the stage's end (closest: slots < min(n_cand, 8 k_end);
    any hit: slots < n_cand), in mt_sweep_rows' arithmetic: (t, tri) by
    the lexicographic (t, least id) rule, or occlusion."""
    rays = T(case["rays"])
    nb, _, t_lanes = rays.shape
    order = case["order_g"].reshape(nb, -1)
    v0, e1, e2 = (pack[:, r:r + 3].transpose(1, 2) for r in (0, 3, 6))
    tid = pack[:, 9].contiguous().view(torch.int32)
    out_t = torch.full((nb, t_lanes), np.inf)
    out_id = torch.full((nb, t_lanes), I32_MAX, dtype=torch.int32)
    occ = torch.zeros((nb, t_lanes), dtype=torch.bool)
    for b in range(nb):
        n = int(case["n_cand"][b])
        if closest:
            n = min(n, GROUP * k_end)
        cl = torch.as_tensor(order[b, :n], dtype=torch.long)
        if cl.numel() == 0:
            continue
        o, d = rays[b, 0:3].T, rays[b, 3:6].T
        tri = [a[cl].reshape(-1, 3)[None, :, i] for a in (v0, e1, e2)
               for i in range(3)]
        ray = [o[:, i, None] for i in range(3)] + [d[:, i, None]
                                                    for i in range(3)]
        t, ok = cuda_ctiles.mt_sweep_rows(*ray, *tri, float(rays[b, 7, 0]),
                                          rays[b, 6][:, None])
        occ[b] = ok.any(dim=1)
        ids = tid[cl].reshape(-1)
        t = torch.where(ok, t, np.inf)
        tmin_ = t.amin(dim=1)
        out_t[b] = tmin_
        out_id[b] = torch.where(ok & (t == tmin_[:, None]), ids[None],
                                I32_MAX).amin(dim=1)
    return (out_t, out_id) if closest else (occ,)


STAGE_OPTIONS = {False: [dict(), dict(early_skip=True, sub_skip=True)],
                 True: [dict(), dict(sub_skip=False)]}


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("name", cases.FUSED_CASES)
def test_stages_match_the_host_stepped_loop(monkeypatch, name, closest):
    case = cases.fused_cascade_case(name, S, 64)
    pack, blocks3 = _case_inputs(case)
    blocks = (blocks3[:2] + (T(case["entry"]),) + blocks3[2:]
              if closest else blocks3)
    swept_set = closest and name in ("retired_face", "retired_tie")
    for kw in STAGE_OPTIONS[closest]:
        (carry, blk), now = _record_now(monkeypatch, lambda: _run_now(
            pack, blocks, _case_carry(case, closest), closest, kw))
        active_fn, sweep_update = _before_rules(pack, blocks, closest, kw)
        (carry_b, blk_b), before = _record_before(
            monkeypatch, lambda: traverse._cascade_traverse(
                blocks, _case_carry(case, closest), sweep_update,
                active_fn))
        assert torch.equal(blk, blk_b)
        if not swept_set:
            _same_stages(now, before)
        else:
            # the entry rule retires blocks whose later group holds a
            # nearer hit or a tie with a smaller id: the set of before
            # missed them
            assert [c[:4] for c in now] == [c[:4] for c in before]
            assert not torch.equal(carry[1], carry_b[1])
        _case_facts(name, case, carry, now, closest)
        if len(now) == 1:  # one stage: the blocks keep their rows
            want = _brute_blocks(case, pack, now[0][3], closest)
            if name == "signed_zero_tie":
                assert torch.equal(carry[0], want[0])  # -0.0 == +0.0
            else:
                assert torch.equal(_bits(carry[0]), _bits(want[0]))
            if closest:
                assert torch.equal(carry[1], want[1])


def _case_facts(name, case, carry, calls, closest):
    """What each crafted case is there to show happened."""
    sizes = [c[0] for c in calls]
    if name == "half_active":
        size, thr, _, _, act, _ = calls[0]
        assert (size, thr, int(act.sum())) == (128, 64, 64)
    if name in ("small_nb", "later_tie", "retired_tie", "signed_zero_tie"):
        assert sizes == [40] and calls[0][1] == 0
    if name == "all_dead":
        assert calls[-1][3] == 0
        assert not (torch.isfinite(carry[0]).any() if closest
                    else carry[0].any())
    if name == "carried_k":
        assert len(calls) == 4 and calls[-1][2] > 0
    if name == "no_candidates":
        assert (case["n_cand"][::3] == 0).all()
    if not closest:
        return
    ids = carry[1]
    if name == "retired_face":
        s11 = (ids >= 100 + 11 * S) & (ids < 100 + 12 * S)
        assert s11.any()
    if name in ("later_tie", "retired_tie"):
        # every lane meets cluster 0 and its copy, cluster 12, at one t;
        # the copy's ids are the smaller
        assert bool((ids < S).all())
    if name == "signed_zero_tie":
        t = carry[0]
        assert bool((t == 0.0).all()) and bool((ids < 100 + S).all())


@pytest.mark.parametrize("closest", [False, True])
def test_an_id_out_of_range_raises(closest):
    case = cases.fused_cascade_case("small_nb", S, 64, bad_id=True)
    pack, blocks = _case_inputs(case)
    if closest:
        blocks = blocks[:2] + (T(case["entry"]),) + blocks[2:]
    with pytest.raises(ValueError, match=r"outside \[0, 13\]"):
        _run_now(pack, blocks, _case_carry(case, closest), closest, {})


def test_stage_kernel_chunk_is_the_plain_step():
    """On the CPU the plain version sweeps kernel_chunk blocks a call; the
    result is the same at any chunk."""
    case = cases.fused_cascade_case("carried_k", S, 64)
    pack, blocks = _case_inputs(case)
    sizes = []
    real = cuda_anyhit.block_anyhit

    def spy(tri_pack, rays, cid8, **kw):
        sizes.append(rays.shape[0])
        return real(tri_pack, rays, cid8, **kw)

    want, _ = _run_now(pack, blocks, _case_carry(case, False), False, {})
    cuda_anyhit.block_anyhit = spy
    try:
        got, _ = _run_now(pack, blocks, _case_carry(case, False), False,
                          dict(kernel_chunk=7))
    finally:
        cuda_anyhit.block_anyhit = real
    assert torch.equal(got[0], want[0])
    assert max(sizes) == 7


# ---- whole cascades on random soups ----------------------------------------

def _before_any(accel, o, d, t_min, t_max, block_size=128, sort_mode="dir",
                early_skip=False, kernel_chunk=8192, sort=True,
                sub_skip=False, exact_cull=0):
    """any_hit_fused as it was: _cascade_traverse."""
    n0 = o.shape[0]
    o, d, t_max, perm, n_cand, _entry, order_g = \
        cuda_anyhit.prepare_fused_wave(accel, o, d, t_max, block_size, sort,
                                       sort_mode, t_min, exact_cull)
    nb = n_cand.shape[0]
    pack = cuda_anyhit.pack_tris_dummy(accel)
    rays = pack_rays_tiles(o, d, t_max, block_size, t_min=float(t_min))
    active_fn, sweep_update = _before_any_rules(
        pack, order_g.shape[1] - 1, early_skip, sub_skip, kernel_chunk)
    carry, blk = traverse._cascade_traverse(
        (rays, n_cand, order_g),
        (torch.zeros((nb, block_size), dtype=torch.bool),), sweep_update,
        active_fn)
    occ = traverse._unpermute_blocks(carry[0], blk).reshape(-1)
    return traverse._unsort(occ, perm)[:n0]


def _before_closest(accel, o, d, t_min, t_max, block_size=128,
                    sort_mode="octorig", sub_skip=True, kernel_chunk=8192,
                    sort=True, exact_cull=0):
    """closest_hit_fused as it was: _cascade_traverse, the active blocks
    swept."""
    n0 = o.shape[0]
    o, d, t_max, perm, n_cand, entry, order_g = \
        cuda_anyhit.prepare_fused_wave(accel, o, d, t_max, block_size, sort,
                                       sort_mode, t_min, exact_cull)
    nb = n_cand.shape[0]
    pack = cuda_anyhit.pack_tris_dummy(accel)
    rays = pack_rays_tiles(o, d, t_max, block_size, t_min=float(t_min))
    active_fn, sweep_update = _before_closest_rules(
        pack, order_g.shape[1] - 1, sub_skip, kernel_chunk)
    carry, blk = traverse._cascade_traverse(
        (rays, n_cand, entry, order_g),
        (torch.full((nb, block_size), np.inf),
         torch.full((nb, block_size), I32_MAX, dtype=torch.int32)),
        sweep_update, active_fn)
    best_t, best_id = (traverse._unsort(traverse._unpermute_blocks(
        a, blk).reshape(-1), perm)[:n0] for a in carry)
    hit = torch.isfinite(best_t)
    return hit, best_t, torch.where(hit, best_id, -1)


ANY_OPTIONS = [dict(), dict(early_skip=True), dict(sub_skip=True),
               dict(early_skip=True, sub_skip=True, sort=False),
               dict(exact_cull=16), dict(exact_cull=16, sort=False)]
CLOSEST_OPTIONS = [dict(), dict(sub_skip=False), dict(sort=False),
                   dict(exact_cull=16), dict(exact_cull=16, sort=False)]
SOUPS = [(600, 16, 256, 4, (0.5, 15.0)), (300, 128, 173, None, 9.0)]


def _soup(rng, n_tris, s, n, dead_every, tmax):
    sc = _scene(rng, n_tris, s)
    scalar = not isinstance(tmax, tuple)
    o, d, tm = _wave(rng, sc, n, dead_every, None if scalar else tmax)
    tm_t = torch.full((n,), float(tmax)) if scalar else T(tm)
    return sc, (T(o), T(d), 1e-3, tm_t), o, d, (tmax if scalar
                                                else jnp.asarray(tm))


@pytest.mark.parametrize("soup", range(len(SOUPS)))
def test_any_hit_fused_matches_before_jax_and_bruteforce(monkeypatch, rng,
                                                         soup):
    sc, args, o, d, jtm = _soup(rng, *SOUPS[soup])
    bf = intersect.any_hit(sc["ptris"], *args)
    assert 0.05 < float(bf.float().mean()) < 0.95
    for kw in ANY_OPTIONS:
        got, now = _record_now(monkeypatch, lambda: cuda_anyhit.any_hit_fused(
            sc["pa"], *args, kernel_chunk=8, **kw))
        want, before = _record_before(monkeypatch, lambda: _before_any(
            sc["pa"], *args, kernel_chunk=8, **kw))
        _same_stages(now, before)
        assert torch.equal(got, want) and torch.equal(got, bf), kw
    if soup == 0:
        for kw in (dict(), dict(early_skip=True, sub_skip=True, sort=False)):
            jo = janyhit.any_hit_fused(sc["ja"], jnp.asarray(o),
                                       jnp.asarray(d), 1e-3, jtm,
                                       interpret=True, **kw)
            np.testing.assert_array_equal(np.asarray(jo), bf.numpy())


@pytest.mark.parametrize("soup", range(len(SOUPS)))
def test_closest_hit_fused_matches_before_jax_and_bruteforce(monkeypatch,
                                                             rng, soup):
    sc, args, o, d, jtm = _soup(rng, *SOUPS[soup])
    bf = intersect.closest_hit(sc["ptris"], *args)
    assert float(bf.hit.float().mean()) > 0.05
    for kw in CLOSEST_OPTIONS:
        got, now = _record_now(monkeypatch,
                               lambda: cuda_closest.closest_hit_fused(
                                   sc["pa"], *args, kernel_chunk=8, **kw))
        want, before = _record_before(monkeypatch, lambda: _before_closest(
            sc["pa"], *args, kernel_chunk=8, **kw))
        _same_stages(now, before)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kw
        assert torch.equal(got.hit, bf.hit)
        assert torch.equal(got.t.view(torch.int32), bf.t.view(torch.int32))
        assert torch.equal(got.tri[bf.hit], bf.tri[bf.hit])
    if soup == 0:
        jh = jclosest.closest_hit_fused(sc["ja"], jnp.asarray(o),
                                        jnp.asarray(d), 1e-3, jtm,
                                        interpret=True)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(jh.hit))
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(jh.tri))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(jh.t), **T_TOL)


def test_all_dead_waves(rng):
    sc = _scene(rng, 200, 64)
    o, d, _ = _wave(rng, sc, 300)
    dead = torch.full((300,), -1.0)
    args = (sc["pa"], T(o), T(d), 1e-3, dead)
    assert not cuda_anyhit.any_hit_fused(*args, early_skip=True).any()
    fh = cuda_closest.closest_hit_fused(*args)
    assert not fh.hit.any() and (fh.tri == -1).all()


# ---- the crafted scene: the sweep set decides a tie ------------------------

def test_the_closest_sweep_set_is_the_jax_package_s():
    sc = cases.fused_tie_scene()
    arrays = sc["accel"]
    acc = accel_from_numpy(*arrays, device="cpu")
    args = (T(sc["o"]), T(sc["d"]), sc["t_min"], T(sc["tm"]))
    got = cuda_closest.closest_hit_fused(acc, *args, sort=False)
    before = _before_closest(acc, *args, sort=False)
    # lane 0 meets X (id 50, cluster 0) and its copy (id 10, cluster 8) at
    # one t; the entry of the copy's box is past that t
    assert got.t[0] == sc["t"] and before[1][0] == sc["t"]
    assert int(got.tri[0]) == 10 and int(before[2][0]) == 50
    assert not bool(got.hit[128])
    _order, _nc, entry = traverse._block_candidates(
        acc, args[0].reshape(2, 128, 3), args[1].reshape(2, 128, 3),
        args[3].reshape(2, 128))
    assert float(entry[0, GROUP]) > sc["t"]
    # brute force (the triangles in id order: index i has id ids[i])
    v0, e1, e2, tri_id = (np.asarray(a) for a in arrays[2:6])
    real = tri_id >= 0
    ids = tri_id[real]
    order = np.argsort(ids)
    z = np.zeros((int(real.sum()), 3), np.float32)
    tris = triangles_from_numpy(v0[real][order], (v0 + e1)[real][order],
                                (v0 + e2)[real][order], z, z, z, z[:, :2],
                                z[:, :2], z[:, :2],
                                np.zeros(len(ids), np.int32), device="cpu")
    bf = intersect.closest_hit(tris, *args)
    assert torch.equal(got.t[bf.hit].view(torch.int32),
                       bf.t[bf.hit].view(torch.int32))
    assert int(ids[order][int(bf.tri[0])]) == 10
    # the JAX package's cascade
    ja = JAccel(*(jnp.asarray(a) for a in arrays))
    jh = jclosest.closest_hit_fused(ja, jnp.asarray(sc["o"]),
                                    jnp.asarray(sc["d"]), sc["t_min"],
                                    jnp.asarray(sc["tm"]), sort=False,
                                    interpret=True)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(jh.t), **T_TOL)


# ---- the closest sweep's sub_skip gate at exact ties -----------------------

def _warp_voted(tri_pack, rays, cid8, sub_skip=True, stats=None):
    """block_closest_plain with its gate voted over each 32 lanes, as the
    kernel votes it (a warp's lanes in place of the block's)."""
    size, rows, t_lanes = rays.shape
    w = t_lanes // 32
    r = (rays.reshape(size, rows, w, 32).permute(0, 2, 1, 3)
         .reshape(size * w, rows, 32).contiguous())
    c = cid8.reshape(size, GROUP).repeat_interleave(w, 0).reshape(-1)
    t, tri = cuda_closest.block_closest_plain(tri_pack, r, c.contiguous(),
                                              sub_skip)
    return t.reshape(size, t_lanes), tri.reshape(size, t_lanes)


@pytest.mark.parametrize("name", ["carried_k", "later_tie", "retired_face"])
def test_closest_gate_keeps_exact_ties_at_any_vote_width(name):
    """On cascades whose hits tie across clusters on their boxes' faces
    (cluster 0 and its rewound copy, cluster 10, in one plane), the
    sub_skip gate gives the ungated sweep's bits whether a block or each 32
    of its lanes vote: a tie's t can lie a few ulps under its box's f32
    slab entry, which a gate on the box itself would skip
    (cuda_closest.gate_lanes grows the box)."""
    from functools import partial

    case = cases.fused_cascade_case(name, 128, 128)
    pack, blocks3 = _case_inputs(case)
    blocks = blocks3[:2] + (T(case["entry"]),) + blocks3[2:]
    outs = []
    for sweep in (lambda *a, **k: cuda_closest.block_closest_plain(*a, **k),
                  _warp_voted,
                  lambda *a, **k: cuda_closest.block_closest_plain(
                      *a, **{**k, "sub_skip": False})):
        def stage(b, c, k, thr, sweep=sweep):
            return cuda_cascade.fused_stage_plain(
                pack, b[0], b[3], b[1], c, k, thr, entry=b[2], sweep=sweep)
        outs.append(traverse._cascade_stages(blocks,
                                             _case_carry(case, True), stage))
    for got in outs[:2]:
        assert torch.equal(got[0][1], outs[2][0][1])
        assert torch.equal(_bits(got[0][0]), _bits(outs[2][0][0]))


def test_closest_gate_keeps_a_corner_hit():
    """The crafted corner ray (test_torch_sweep_cases.gate_corner_case):
    its hit, at the end of its window, lies past the f32 slab entry of its
    box by more than 2^-16 of t, so the gate of the box itself, and of
    the box with the window's end widened by 2^-16 of itself, skip it for
    that lane; the grown box (gate_lanes) keeps it. block_closest's sweep
    with sub_skip, whether the block or each 32 of its lanes vote (lane 32
    passes the gate, lane 0 is in the other warp), gives the ungated
    sweep's bits, and lane 0 gets the triangle at the Möller–Trumbore t."""
    case = cases.gate_corner_case()
    geo = {k: case[k] for k in ("v0", "e1", "e2", "tri_id")}
    bb = np.zeros((1, 3), np.float32)
    acc = accel_from_numpy(case["bmin"], case["bmax"], *geo.values(),
                           bb[0], bb[0], bb, bb, bb[None], bb[None],
                           device="cpu")
    pack = cuda_anyhit.pack_tris_dummy(acc)
    rays, cid8 = T(case["rays"]), T(case["cid8"])
    box = pack[:1, 10:16, 0]
    inv = 1.0 / rays[:, 3:6]
    t_lo, cap = rays[:, 7], rays[:, 6]
    lane0 = slice(0, 1)
    for end in (cap, cap + cap.abs() * 2.0 ** -16):
        assert not cuda_ctiles.sub_pred(box, rays[..., lane0],
                                        inv[..., lane0], t_lo[:, lane0],
                                        end[:, lane0]).item()
    touch = cuda_closest.gate_lanes(box, rays, inv, t_lo, cap)
    assert touch[0, 0] and touch[0, 32]
    ungated = cuda_closest.block_closest_plain(pack, rays, cid8, False)
    assert ungated[1][0, 0] == 7
    assert ungated[0][0, 0].item() == cases.GATE_T
    for got in (cuda_closest.block_closest_plain(pack, rays, cid8, True),
                _warp_voted(pack, rays, cid8, True)):
        assert torch.equal(got[1], ungated[1])
        assert torch.equal(_bits(got[0]), _bits(ungated[0]))
