"""The port's accel.ctiles against the JAX package's, brute force and
itself: the flat and 2-level culls, the split pair domain, both overflow
completions, the sort modes and block sizes, the occlusion query, the
tile sweep's sub_skip / pack_t options, and lane-major shadow rays.

Same inputs (numpy, seeded) through `path_tracer_ai_tpu.accel.ctiles` (its
CPU route: use_pallas=False, the XLA sweep, which its docstrings state
agrees exactly with its kernel, sub_skip and pack_t included) and the
port's, where the sweep is tile_sweep's plain version. hit, tri, occlusion
and the candidate tables must match exactly; t within rtol 1e-6 plus atol
2e-6 (XLA's CPU code contracts FMAs, eager torch does not; ROADMAP §3).
Against the port's own brute force, t is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import ctiles as jctiles
from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu_torch.accel import ctiles, cuda_ctiles, worklist
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)

# (soup triangles, cluster size, super size, rays, options); tile_chunk and
# row_chunk small so that the sweep and the cull run in several chunks
CASES = {
    "flat": (600, 16, 4, 256, dict(tile_chunk=4, row_chunk=8)),
    # levels=2 with both overflows: super_cap 4 of 10 supers, cap 16
    "levels2_overflow": (600, 16, 4, 256, dict(levels=2, super_cap=4, cap=16,
                                               tile_chunk=4, row_chunk=8)),
    "levels2_split2": (600, 16, 4, 256, dict(levels=2, super_cap=16, cap=32,
                                             pair_split=2, tile_chunk=4)),
    # pair_split=1 on a crowded soup: the nb // 8 tail budget overflows
    "split1": (800, 8, 4, 256, dict(pair_split=1, tile_chunk=8)),
    "unsorted": (600, 16, 4, 192, dict(sort=False, tile_chunk=4)),
    "block4_dir": (600, 16, 4, 192, dict(block=4, tile_blocks=4,
                                         sort_mode="dir", tile_chunk=4)),
}


# the cases whose occlusion is held against JAX's too (the others against
# brute force only: each JAX configuration costs a compilation)
JAX_ANY_HIT = ("flat", "levels2_overflow", "split1")


def _jax(ja, o, d, tm, kw, any_hit=True):
    args = (ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    h = jctiles.closest_hit_ctiles(*args, **kw)
    if not any_hit:
        return h, None
    return h, np.asarray(jctiles.any_hit_ctiles(*args, **kw))


def _assert_closest(ht, hj):
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctiles_matches_jax(rng, case):
    """closest_hit_ctiles and any_hit_ctiles against JAX's with the same
    options, then the port's fallback_sorted forms, sub_skip and
    pallas_pack_t (which leave JAX's result as it is) against the same
    result; the port's t bitwise against its brute force."""
    n_tris, s, ss, n, kw = CASES[case]
    ja, pa, ptris = _scene(rng, n_tris, s, super_size=ss)
    o, d, tm = _rays(rng, n)
    tm[1::5] = np.inf
    hj, occ_j = _jax(ja, o, d, tm, kw, any_hit=case in JAX_ANY_HIT)
    args = (pa, T(o), T(d), 1e-3, T(tm))
    bf = intersect.closest_hit(ptris, *args[1:])
    occ_bf = intersect.any_hit(ptris, *args[1:]).numpy()
    if occ_j is not None:
        np.testing.assert_array_equal(occ_bf, occ_j)
    assert np.asarray(hj.hit).mean() > 0.05 and occ_bf.mean() > 0.05
    variants = [dict(), dict(fallback_sorted=True), dict(sub_skip=True),
                dict(pallas_pack_t=True, fallback_sorted=True)]
    for extra in variants:
        ht = ctiles.closest_hit_ctiles(*args, **kw, **extra)
        _assert_closest(ht, hj)
        np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
        occ = ctiles.any_hit_ctiles(*args, **kw, **extra)
        np.testing.assert_array_equal(occ.numpy(), occ_bf)


def test_overflows_fire_in_the_cases(rng):
    """The overflow cases do overflow: super_cap 4 and cap 16 each send
    blocks to the fallback, and pair_split=1 passes its tail budget."""
    ja, pa, _ = _scene(rng, 600, 16, super_size=4)
    o, d, tm = _rays(rng, 256)
    blocks = worklist._prepare_blocks(pa, T(o), T(d), T(tm), 8, True,
                                      "octorig")
    _, n_ok, over_s = ctiles._block_candidates_2level(
        pa, *blocks[:3], 1e-3, 64, 8, 4)
    _, _, over_c = ctiles._block_candidates_2level(
        pa, *blocks[:3], 1e-3, 16, 8, 64)
    assert bool(over_s.any()) and bool(over_c.any())
    ja, pa, _ = _scene(rng, 800, 8, super_size=4)
    o, d, tm = _rays(rng, 256)
    blocks = worklist._prepare_blocks(pa, T(o), T(d), T(tm), 8, True,
                                      "octorig")
    cand, n_cand = ctiles._ray_masks(pa, *blocks[:3], 1e-3, 8)
    order, n_cand, over = ctiles._extract_order_flat(pa, cand, n_cand, 48)
    pairs = ctiles._build_pairs(pa, order, n_cand, over, 48, 16,
                                split_head=1)
    assert int(pairs["overflow"].sum()) > int(over.sum())


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("super_cap,cap", [(4, 32), (16, 16), (16, 64)])
def test_block_candidates_2level_tables_match_jax(rng, super_cap, cap, live):
    """(order, n_cand, over) of the 2-level cull bitwise against JAX's,
    every slot, with and without the live-block bound (rows past the
    computed chunks hold 0, as JAX's do)."""
    ja, pa, _ = _scene(rng, 600, 16, super_size=4)
    o, d, tm = _rays(rng, 256)
    tm[200:] = -1.0
    jb = jworklist._prepare_blocks(ja, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), 8, True, "octorig")
    pb = worklist._prepare_blocks(pa, T(o), T(d), T(tm), 8, True, "octorig")
    lb = -(-int((tm >= 0).sum()) // 8) if live else None
    tj = jctiles._block_candidates_2level(ja, *jb[:3], 1e-3, cap, 4,
                                          super_cap, live_blocks=lb)
    tt = ctiles._block_candidates_2level(pa, *pb[:3], 1e-3, cap, 4,
                                         super_cap, live_blocks=lb)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coplanar_cluster_flat_aabb(rng):
    """A cluster of triangles in the plane z = 0 has a flat box: the
    inclusive slab keeps it, in both culls, against JAX and brute force."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
    from path_tracer_ai_tpu_torch.convert import accel_from_numpy

    k = 64
    v0 = np.concatenate([rng.uniform(-3, 3, (k, 2)), np.zeros((k, 1))],
                        1).astype(np.float32)
    v1 = v0 + np.asarray([0.6, 0.0, 0.0], np.float32)
    v2 = v0 + np.asarray([0.0, 0.6, 0.0], np.float32)
    tris = SimpleNamespace(v0=v0, v1=v1, v2=v2)
    ja = jbuild(tris, cluster_size=16, super_size=2)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = SimpleNamespace(v0=T(v0), v1=T(v1), v2=T(v2))
    n = 128
    o = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        np.full((n, 1), 2.0)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    tm = np.full(n, np.inf, np.float32)
    hj, occ_j = _jax(ja, o, d, tm, dict(tile_chunk=4))
    assert np.asarray(hj.hit).mean() > 0.2
    for kw in (dict(levels=1), dict(levels=2, super_cap=4)):
        ht = ctiles.closest_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm),
                                       tile_chunk=4, **kw)
        _assert_closest(ht, hj)
        bf = intersect.closest_hit(ptris, T(o), T(d), 1e-3, T(tm))
        np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
        occ = ctiles.any_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm), **kw)
        np.testing.assert_array_equal(occ.numpy(), occ_j)


def test_auto_levels_past_2048_clusters(monkeypatch):
    """levels=0 takes the 2-level cull past 2048 clusters (blob subdiv 4 in
    clusters of two: 2,564 clusters), as the reference does; exact against
    brute force."""
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(4, device="cpu")
    tris = scene.triangles
    pa = build_clusters(tris, cluster_size=2, device="cpu")
    assert pa.num_clusters > 2048
    called = []
    real = ctiles._block_candidates_2level
    monkeypatch.setattr(ctiles, "_block_candidates_2level",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    n = 256
    o = (tris.v0.numpy()[rng.integers(0, tris.v0.shape[0], n)]
         + rng.standard_normal((n, 3)).astype(np.float32) * 0.05)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 8.0, n).astype(np.float32)
    tm[::6] = -1.0
    args = (pa, T(o), T(d), 1e-3, T(tm))
    ht = ctiles.closest_hit_ctiles(*args, tile_chunk=64)
    assert len(called) == 1
    bf = intersect.closest_hit(tris, *args[1:])
    assert bf.hit.numpy().mean() > 0.1
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
    hit = bf.hit.numpy()
    np.testing.assert_array_equal(ht.tri.numpy()[hit], bf.tri.numpy()[hit])
    occ = ctiles.any_hit_ctiles(*args, tile_chunk=64)
    np.testing.assert_array_equal(occ.numpy(),
                                  intersect.any_hit(tris, *args[1:]).numpy())


# --- tile_sweep's options ----------------------------------------------------

def _tiles(rng, pa, t_lanes, nt, g=1):
    """Bounce-like tiles around each tile's first cluster, every 7th lane
    dead, some lanes with short t_max."""
    c, s = pa.num_clusters, pa.cluster_size
    cid = rng.integers(0, c, (nt, g)).astype(np.int32)
    v0 = pa.v0.numpy()
    o = v0[cid[:, :1], rng.integers(0, s, (nt, t_lanes))].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 0.3
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.2, 6.0, o.shape[0]).astype(np.float32)
    tm[::7] = -1.0
    rays = cuda_ctiles.pack_rays_tiles(T(o), T(d), T(tm), t_lanes)
    return rays, T(cid if g > 1 else cid[:, 0])


@pytest.mark.parametrize("t_lanes,s,g", [(128, 96, 1), (64, 64, 2),
                                         (128, 48, 1)])
def test_tile_sweep_options_equal_the_default(rng, t_lanes, s, g):
    """tile_sweep_plain with sub_skip (the 16-row pack) and with pack_t (its
    transpose) give the default's bits; sub_skip sweeps fewer tests, and
    counts the live lanes' tests of the sub-slabs it sweeps."""
    _, pa, _ = _scene(rng, 400, s, super_size=4)
    rays, cid = _tiles(rng, pa, t_lanes, 24, g)
    t0, tri0 = cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris(pa), rays, cid)
    assert (tri0 != cuda_ctiles.I32_MAX).sum() > 0
    st_off, st_on = {}, {}
    cuda_ctiles.tile_sweep_plain(cuda_ctiles.pack_tris(pa), rays, cid,
                                 stats=st_off)
    for kw, pack in ((dict(sub_skip=True), cuda_ctiles.pack_tris16(pa)),
                     (dict(pack_t=True), cuda_ctiles.pack_tris16_t(pa))):
        t1, tri1 = cuda_ctiles.tile_sweep(pack, rays, cid, **kw)
        np.testing.assert_array_equal(t1.view(torch.int32).numpy(),
                                      t0.view(torch.int32).numpy())
        np.testing.assert_array_equal(tri1.numpy(), tri0.numpy())
    cuda_ctiles.tile_sweep_plain(cuda_ctiles.pack_tris16(pa), rays, cid,
                                 sub_skip=True, stats=st_on)
    live = int((rays[:, 6] >= 0).sum())
    assert st_off["lane_tests"] == live * s * g
    assert 0 < st_on["lane_tests"] < st_off["lane_tests"]
    assert st_on["lane_tests"] <= st_on["tests"] < st_off["tests"]


def test_tile_sweep_options_together_raise(rng):
    _, pa, _ = _scene(rng, 200, 16)
    rays, cid = _tiles(rng, pa, 64, 2)
    with pytest.raises(ValueError, match="sub_skip"):
        cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris16(pa), rays, cid,
                               sub_skip=True, pack_t=True)
    o, d, tm = _rays(rng, 64)
    with pytest.raises(ValueError, match="sub_skip"):
        ctiles.closest_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm), sub_skip=True,
                                  pallas_pack_t=True)


def test_sub_skip_matches_pallas_interpret(rng):
    """JAX's own kernel with sub_skip, in interpret mode at a tiny shape
    (one group of 8 tiles of 64 lanes, clusters of 64), against the port's
    plain sub_skip sweep."""
    from path_tracer_ai_tpu.accel import pallas_ctiles as pc

    ja, pa, _ = _scene(rng, 300, 64, super_size=4)
    rays, cid = _tiles(rng, pa, 64, pc.GROUP)
    cid = torch.full_like(cid, int(cid[0]))  # one cluster a group of 8 tiles
    t_j, tri_j = pc.tile_sweep(pc.pack_tris(ja), jnp.asarray(rays.numpy()),
                               jnp.asarray(cid.numpy()), interpret=True,
                               sub_skip=True)
    t_t, tri_t = cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris16(pa), rays,
                                        cid, sub_skip=True)
    assert (np.asarray(tri_j) != cuda_ctiles.I32_MAX).sum() > 0
    np.testing.assert_array_equal(tri_t.numpy(), np.asarray(tri_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), **T_TOL)


# --- lane-major shadow rays --------------------------------------------------

def test_direct_lighting_lane_major_matches_jax(rng):
    """direct_lighting with an occlusion function marked lane_major: the
    query (its rays in lane-major order) and the result equal JAX's, and
    the result equals the port's light-major one bitwise."""
    from path_tracer_ai_tpu.engine import shading as jshading
    from path_tracer_ai_tpu.core.types import Lights as JLights
    from path_tracer_ai_tpu_torch.core.types import Lights
    from path_tracer_ai_tpu_torch.engine import shading

    n, n_lights = 96, 4
    lp = rng.uniform(-4, 4, (n_lights, 3)).astype(np.float32)
    col = rng.uniform(0.2, 1.0, (n_lights, 3)).astype(np.float32)
    inten = rng.uniform(5, 20, n_lights).astype(np.float32)
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    view = rng.standard_normal((n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    mtype = rng.integers(0, 3, n).astype(np.int32)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = rng.uniform(0, 0.5, n).astype(np.float32)
    ior = np.full(n, 1.5, np.float32)
    active = rng.uniform(size=n) < 0.8
    queries = {}

    def occluder(name, xp):
        def occ(o, d, t_max):
            queries[name] = (np.asarray(o), np.asarray(d), np.asarray(t_max))
            # a deterministic occluder: the plane y = 0.5
            oy, dy = o[:, 1], d[:, 1]
            t = (0.5 - oy) / dy
            return (t > 1e-3) & (t < t_max)
        occ.lane_major = name != "port_light"
        return occ

    jl = JLights(position=jnp.asarray(lp), color=jnp.asarray(col),
                 intensity=jnp.asarray(inten))
    jm = jshading.MaterialLanes(mtype=jnp.asarray(mtype),
                                albedo=jnp.asarray(albedo),
                                roughness=jnp.asarray(rough),
                                ior=jnp.asarray(ior))
    ref = np.asarray(jshading.direct_lighting(
        jl, occluder("jax", jnp), jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(view), jm, jnp.asarray(active)))
    pl = Lights(position=T(lp), color=T(col), intensity=T(inten))
    pm = shading.MaterialLanes(mtype=T(mtype), albedo=T(albedo),
                               roughness=T(rough), ior=T(ior))
    out = {}
    for name in ("port", "port_light"):
        out[name] = shading.direct_lighting(
            pl, occluder(name, torch), T(pos), T(nrm), T(view), pm,
            T(active)).numpy()
    for a, b in zip(queries["port"], queries["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(queries["port"][2].reshape(n, n_lights).T,
                                  queries["port_light"][2].reshape(
                                      n_lights, n))
    np.testing.assert_array_equal(out["port"], out["port_light"])
    np.testing.assert_array_equal(out["port"], ref)
