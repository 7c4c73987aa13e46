"""The first-slot sweeps of the packet cascade and the perray queries
against the JAX package's, on the CPU.

`closest_hit_packets`, `closest_hit_perray` and `any_hit_perray` sweep on
the card through the first-slot instances of `tile_sweep` and
`kslot_sweep` (tie="slot") and through `kslot_sweep`'s any-hit sweep; on
the CPU through the plain eager sweeps (`traverse._packet_sweep_closest`,
`_packet_sweep_any`). Held here, with the same numpy inputs:

- the plain versions of the two first-slot instances (`tile_sweep_plain`,
  `kslot_sweep_plain`, tie="slot") against the JAX package's sweep body
  (`_mt_sweep`, then argmin over the slots: traverse.py:823-845 and
  648-665) and against the eager helper, on the crafted first-slot cases
  of tests/test_torch_sweep_cases.py (exact t ties across the clusters of
  a tile and within one cluster, where the first slot's id is the larger,
  so that the oracle's min-id rule and the first-slot rule part; dead
  lanes; misses; a cluster named twice);
- the three queries against JAX's on a random soup and on a crafted scene
  of exact ties (a triangle copied into two clusters with a smaller id in
  the later one, and twice into one cluster; groups of 1, so that the tie
  falls across two groups and the later group's t is exactly the running
  best; rays whose t_max is exactly the hit's t; dead rays; perray's
  filler slots past n_cand), each also with the kernel route's cascade
  logic forced on the CPU (`traverse._kernel_sweeps` True: the wrappers
  then run the instances' plain versions), which must give the same bits.

hit, tri and occlusion exact; t at rtol 1e-6 + atol 2e-6 against JAX
(XLA's CPU code contracts FMAs, eager torch does not; ROADMAP §3) and
bitwise between the port's routes.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel.clusters import ClusterAccel as JAccel
from path_tracer_ai_tpu.accel.traverse import _mt_sweep
from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_kslots, traverse
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)

I32_MAX = 2**31 - 1
CPU_SIZES = (2, 16, 96)


def _geo(case):
    return types.SimpleNamespace(
        v0=T(case["v0"]), e1=T(case["e1"]), e2=T(case["e2"]),
        tri_id=T(case["tri_id"]), cluster_size=case["v0"].shape[1])


def _jax_first_slot(case, o, d, tcap, cid):
    """The JAX package's sweep body: blocks o/d [n, R, 3], window [t_min,
    tcap [n, R]], against the g * S slots of cid [n, g]; (ct, gid of the
    first slot at ct via argmin)."""
    n = cid.shape[0]
    gather = lambda k: jnp.asarray(case[k])[jnp.asarray(cid)].reshape(n, -1, 3)
    t, _ = _mt_sweep(jnp.asarray(o), jnp.asarray(d), gather("v0"),
                     gather("e1"), gather("e2"), case["t_min"],
                     jnp.asarray(tcap))
    slot = jnp.argmin(t, axis=-1)
    cti = jnp.asarray(case["tri_id"])[jnp.asarray(cid)].reshape(n, -1)
    return (np.asarray(jnp.min(t, axis=-1)),
            np.asarray(jnp.take_along_axis(cti, slot, axis=1)))


def _assert_first_slot(got_t, got_tri, ref_t, ref_tri, eager):
    """got (the instance's plain version) against JAX's body and the eager
    helper: t within T_TOL of JAX's and bitwise the helper's; tri exact
    where the lane hits, INT32_MAX where it misses."""
    hit = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t), hit)
    np.testing.assert_allclose(got_t, ref_t, **T_TOL)
    np.testing.assert_array_equal(got_tri[hit], ref_tri[hit])
    assert (got_tri[~hit] == I32_MAX).all()
    np.testing.assert_array_equal(got_t.view(np.int32),
                                  eager[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got_tri[hit], eager[1].numpy()[hit])


@pytest.mark.parametrize("name", cases.FIRST_CASES)
@pytest.mark.parametrize("t_lanes,g", [(1, 1), (64, 4), (64, 8), (1, 8)])
def test_tile_sweep_first_slot_matches_jax(name, t_lanes, g):
    """tile_sweep(tie="slot") on the CPU (its plain version) on the crafted
    first-slot tiles: JAX's argmin sweep and the eager helper; on the tie
    cases the oracle's rule (tie="tri") gives other ids."""
    for s in CPU_SIZES:
        case = cases.first_case(name, s, t_lanes, g)
        rays, cid = case["rays"], case["tile_cid"]
        o, d, tcap = (rays[:, 0:3].transpose(0, 2, 1),
                      rays[:, 3:6].transpose(0, 2, 1), rays[:, 6])
        ref = _jax_first_slot(case, o, d, tcap, cid)
        eager = traverse._packet_sweep_closest(_geo(case), T(o), T(d),
                                               T(tcap), T(cid), case["t_min"])
        pack = T(cases.pack(case))
        got = cuda_ctiles.tile_sweep(pack, T(rays), T(cid), tie="slot")
        _assert_first_slot(got[0].numpy(), got[1].numpy(), *ref, eager)
        hit = np.isfinite(ref[0])
        assert hit.any()
        if name == "dead_lanes":
            assert not hit[tcap < 0].any()
        if name.startswith("ties") and g > 1 or name == "ties_within_cluster":
            oracle = cuda_ctiles.tile_sweep(pack, T(rays), T(cid))
            assert (oracle[1].numpy()[hit] != got[1].numpy()[hit]).any()
            np.testing.assert_array_equal(oracle[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("name", cases.FIRST_CASES)
@pytest.mark.parametrize("k", cases.FIRST_G)
def test_kslot_sweep_first_slot_matches_jax(name, k):
    """kslot_sweep(tie="slot") on the CPU (its plain version) on the crafted
    first-slot rows: the perray sweep body of JAX (one-ray blocks) and the
    eager helper; tie="slot" without want_tri is a ValueError."""
    for s in CPU_SIZES:
        case = cases.first_kslot_case(name, s, k)
        rays, cid = case["rays"], case["cid"]
        o, d, tcap = rays[:, None, 0:3], rays[:, None, 3:6], rays[:, 6:7]
        ref = _jax_first_slot(case, o, d, tcap, cid)
        eager = traverse._packet_sweep_closest(_geo(case), T(o), T(d),
                                               T(tcap), T(cid), case["t_min"])
        got = cuda_kslots.kslot_sweep(T(cases.pack(case)), T(rays), T(cid),
                                      T(case["n_slots"]), True, tie="slot")
        _assert_first_slot(got[0].numpy(), got[1].numpy(), ref[0][:, 0],
                           ref[1][:, 0], (eager[0][:, 0], eager[1][:, 0]))
        assert np.isfinite(ref[0]).any()
    with pytest.raises(ValueError, match="closest"):
        cuda_kslots.kslot_sweep(T(cases.pack(case)), T(rays), T(cid),
                                T(case["n_slots"]), False, tie="slot")


def test_first_slot_rejects_options():
    case = cases.first_case("misses", 16, 64, 4)
    args = (T(cases.pack(case)), T(case["rays"]), T(case["tile_cid"]))
    for kw in (dict(sub_skip=True), dict(pack_t=True), dict(tie="min")):
        with pytest.raises(ValueError):
            cuda_ctiles.tile_sweep(*args, **({"tie": "slot"} | kw))


# --- the queries ------------------------------------------------------------

def _tie_scene():
    """Exact ties on the plane y = 0 (t = 2 from y = 2 straight down; every
    product exact, so t is 2.0 in both packages). S = 4:
    cluster 0: the triangle A twice, ids 50 then 10 (a tie within the
               cluster, the later slot's id smaller); two padding slots;
    cluster 1: A once more, id 5 (a tie across clusters; the box equals
               cluster 0's, so the cull's stable order puts 0 first);
    cluster 2: the plane y = -1 under A (t = 3), id 7;
    cluster 3: a triangle at x in [3, 5], y = 0 (its own rays), id 3.
    The first-slot rule returns 50 where the oracle returns 5."""
    s = 4
    v0 = np.zeros((4, s, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    tri_id = np.full((4, s), -1, np.int32)
    a = ((-1.0, 0.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0))
    for c, j, tid in ((0, 0, 50), (0, 1, 10), (1, 0, 5)):
        v0[c, j], e1[c, j], e2[c, j] = a
        tri_id[c, j] = tid
    v0[2, 0], e1[2, 0], e2[2, 0] = (-1.0, -1.0, -1.0), a[1], a[2]
    tri_id[2, 0] = 7
    v0[3, 0], e1[3, 0], e2[3, 0] = (3.0, 0.0, -1.0), a[1], a[2]
    tri_id[3, 0] = 3
    live = tri_id >= 0
    v1, v2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    bmin = np.where(live[..., None], lo, np.inf).min(1).astype(np.float32)
    bmax = np.where(live[..., None], hi, -np.inf).max(1).astype(np.float32)
    big = np.float32(3.0e37)
    cbmin = np.full((1, 16, 3), big, np.float32)
    cbmax = np.full((1, 16, 3), -big, np.float32)
    cbmin[0, :4], cbmax[0, :4] = bmin, bmax
    return (bmin, bmax, v0, e1, e2, tri_id, bmin.min(0), bmax.max(0),
            bmin.min(0)[None], bmax.max(0)[None], cbmin, cbmax)


def _tie_rays(rng, n):
    """Rays straight down from y = 2: a quarter over cluster 3, the rest
    inside A (x + z <= 0); t_max inf, exactly 2 (the hit's t: inclusive),
    just below 2 (a miss) or -1 (dead), in turn."""
    x = rng.uniform(-0.6, -0.1, n)
    z = rng.uniform(-0.6, -0.1, n)
    x[::4] += 4.0
    o = np.stack([x, np.full(n, 2.0), z], 1).astype(np.float32)
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (n, 1))
    tm = np.tile(np.float32([np.inf, 2.0, np.nextafter(np.float32(2.0),
                                                       np.float32(0.0)),
                             -1.0, np.inf, 2.0]), -(-n // 6))[:n]
    return o, d, tm


def _kernel_route(monkeypatch):
    """The cascades as they run on the card (one wrapper call an
    iteration), the wrappers falling to their plain versions on the CPU."""
    monkeypatch.setattr(traverse, "_kernel_sweeps", lambda dev: True)


def _same_hits(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("block_size,group_size",
                         [(16, 1), (16, 2), (32, 4), (8, 3)])
def test_closest_hit_packets_ties_match_jax(rng, monkeypatch, block_size,
                                            group_size):
    """closest_hit_packets on the tie scene: JAX's bits (t, hit, tri), the
    first slot's id 50 on every hit over A, and the kernel route's cascade
    the same bits."""
    arrays = _tie_scene()
    ja = JAccel(*(jnp.asarray(x) for x in arrays))
    pa = accel_from_numpy(*arrays, device="cpu")
    o, d, tm = _tie_rays(rng, 96)
    hj = jtraverse.closest_hit_packets(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm),
        block_size=block_size, group_size=group_size)
    ht = traverse.closest_hit_packets(pa, T(o), T(d), 1e-3, T(tm),
                                      block_size=block_size,
                                      group_size=group_size)
    _same_hits(ht, hj)
    hit = ht.hit.numpy()
    over_a = o[:, 0] < 1.0
    assert hit.sum() > 30 and (ht.t.numpy()[hit] == 2.0).all()
    assert (ht.tri.numpy()[hit & over_a] == 50).all()
    assert (ht.tri.numpy()[hit & ~over_a] == 3).all()
    assert not hit[(tm < 2.0)].any() and hit[(tm == 2.0)].all()
    _kernel_route(monkeypatch)
    _same_hits(traverse.closest_hit_packets(
        pa, T(o), T(d), 1e-3, T(tm), block_size=block_size,
        group_size=group_size), ht)


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_perray_ties_match_jax(rng, monkeypatch, group_size):
    """closest_hit_perray and any_hit_perray on the tie scene: JAX's bits.
    Over A a ray's candidates are [0, 1, 2] in id order, so at g = 1 the
    tie falls across groups, at g = 2 within one; at g = 2 and 3 the rays
    over cluster 3 sweep the filler ids past their one candidate (C - 1 =
    3, a real cluster), as JAX does. The kernel route gives the same bits."""
    arrays = _tie_scene()
    ja = JAccel(*(jnp.asarray(x) for x in arrays))
    pa = accel_from_numpy(*arrays, device="cpu")
    o, d, tm = _tie_rays(rng, 96)
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), 1e-3, T(tm))
    kw = dict(group_size=group_size)
    hj = jtraverse.closest_hit_perray(*args_j, **kw)
    ht = traverse.closest_hit_perray(*args_t, **kw)
    _same_hits(ht, hj)
    hit = ht.hit.numpy()
    assert hit.sum() > 30
    assert (ht.tri.numpy()[hit & (o[:, 0] < 1.0)] == 50).all()
    occ_j = np.asarray(jtraverse.any_hit_perray(*args_j, **kw))
    occ_t = traverse.any_hit_perray(*args_t, **kw)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(occ_t.numpy(), hit)
    _kernel_route(monkeypatch)
    _same_hits(traverse.closest_hit_perray(*args_t, **kw), ht)
    np.testing.assert_array_equal(
        traverse.any_hit_perray(*args_t, **kw).numpy(), occ_t.numpy())


# (soup triangles, cluster size, rays, options)
SOUP_CASES = {
    "packets_b16_g4": ("packets", 700, 16, 16 * 24,
                       dict(block_size=16, group_size=4)),
    "packets_b32_g8_s8": ("packets", 500, 8, 32 * 12,
                          dict(block_size=32, group_size=8)),
    "perray_g4": ("perray", 600, 16, 256, {}),
    "perray_g3_cap6": ("perray", 600, 8, 256,
                       dict(cap=6, group_size=3, fallback_block=32)),
}


@pytest.mark.parametrize("case", sorted(SOUP_CASES))
def test_queries_match_jax_on_a_soup(rng, monkeypatch, case):
    """The three queries on a random soup (dead rays, per-ray and infinite
    t_max): hit and tri exact, t within T_TOL of JAX's; the kernel route's
    cascade bitwise the CPU route's, through one wrapper call an iteration
    (none of the eager helpers runs)."""
    kind, n_tris, s, n, kw = SOUP_CASES[case]
    ja, pa, _ = _scene(rng, n_tris, s)
    o, d, tm = _rays(rng, n)
    tm[1::5] = np.inf
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), 1e-3, T(tm))
    if kind == "packets":
        queries = [(jtraverse.closest_hit_packets,
                    traverse.closest_hit_packets)]
    else:
        queries = [(jtraverse.closest_hit_perray, traverse.closest_hit_perray),
                   (jtraverse.any_hit_perray, traverse.any_hit_perray)]
    cpu = []
    for jfn, tfn in queries:
        got, ref = tfn(*args_t, **kw), jfn(*args_j, **kw)
        if isinstance(got, traverse.PacketHit):
            assert np.asarray(ref.hit).mean() > 0.03
            np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
            np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
            np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t),
                                       **T_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        cpu.append(got)

    _kernel_route(monkeypatch)
    eager = []
    for name in ("_packet_sweep_closest", "_packet_sweep_any"):
        monkeypatch.setattr(traverse, name,
                            lambda *a, **k: eager.append(1))
    before = (cuda_ctiles.slot_launches, cuda_kslots.slot_launches)
    for (_jfn, tfn), want in zip(queries, cpu):
        got = tfn(*args_t, **kw)
        if isinstance(got, traverse.PacketHit):
            _same_hits(got, want)
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not eager
    # the plain versions count no launch
    assert (cuda_ctiles.slot_launches, cuda_kslots.slot_launches) == before
