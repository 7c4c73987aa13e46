"""Tests of the port that need an NVIDIA GPU (marker `gpu`).

They skip where torch sees no CUDA device. On the GPU machine, which has
no JAX (tests/conftest.py imports it):
    python -m pytest tests/test_torch_cuda.py -q --noconftest
Every kernel must equal its plain version bit for bit (t) and exactly
(cluster, slot, triangle id, occlusion).
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.accel import (
    cuda_anyhit,
    cuda_cascade,
    cuda_closest,
    cuda_ctiles,
    cuda_cull,
    cuda_items,
    cuda_kslots,
    cuda_sweep,
)
from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
from path_tracer_ai_tpu_torch.scene.scene import blob_room_arrays
import test_torch_sweep_cases as cases  # tests/, numpy only

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t_lanes,s", [(128, 256), (64, 128), (128, 128),
                                       (64, 256), (256, 128), (256, 256),
                                       (64, 2), (128, 2)])
def test_tile_sweep_kernel_matches_plain(cuda, rng, t_lanes, s, g):
    """Every compiled (T, S) with one and two clusters a tile; every seventh
    lane dead, whole 32-lane slots dead in some tiles, some tiles all dead."""
    from types import SimpleNamespace

    arr = blob_room_arrays(4)
    acc = build_clusters(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                         cluster_size=s, device=cuda)
    nt = 256
    cid = rng.integers(0, acc.num_clusters, (nt, g)).astype(np.int32)
    v0 = acc.v0.cpu().numpy()
    o = v0[cid[:, :1], rng.integers(0, s, (nt, t_lanes))].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-3
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full((nt, t_lanes), np.inf, np.float32)
    tm.reshape(-1)[::7] = -1.0
    tm[1::5, 32:64] = -1.0          # a dead slot (one warp's second ray)
    tm[2::5, :t_lanes - 32] = -1.0  # only the last slot lives
    tm[3::11] = -1.0                # all lanes dead
    tm = tm.reshape(-1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm), t_lanes)
    pack = cuda_ctiles.pack_tris(acc)
    cid_t = t(cid) if g > 1 else t(cid[:, 0])
    before = cuda_ctiles.launches
    t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid_t)
    assert cuda_ctiles.launches == before + 1
    assert cuda_ctiles.launch_shapes[(t_lanes, s, g)][1] >= nt
    t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, cid_t)
    torch.cuda.synchronize()
    assert (tri_k != cuda_ctiles.I32_MAX).any()
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(tri_k, tri_p)
    assert (tri_k[3::11] == cuda_ctiles.I32_MAX).all()
    if g > 1:  # one launch over G clusters == G launches folded
        t_f, tri_f = cuda_ctiles.tile_sweep(pack, rays, cid_t[:, 0].contiguous())
        for j in range(1, g):
            t_j, tri_j = cuda_ctiles.tile_sweep(pack, rays,
                                                cid_t[:, j].contiguous())
            t_f, tri_f = cuda_ctiles.combine_min_tri(t_f, tri_f, t_j, tri_j)
        assert torch.equal(t_k.view(torch.int32), t_f.view(torch.int32))
        assert torch.equal(tri_k, tri_f)


@pytest.mark.parametrize("option", ["sub_skip", "pack_t"])
@pytest.mark.parametrize("t_lanes,s", [(128, 256), (128, 128), (64, 128)])
def test_tile_sweep_options_match_plain_and_default(cuda, rng, t_lanes, s,
                                                    option):
    """tile_sweep's sub_skip (16-row pack) and pack_t ([C, S, 16] pack)
    instances: bitwise their plain versions and the default instance, on
    tiles with dead lanes, dead slots and finite t_max."""
    from types import SimpleNamespace

    arr = blob_room_arrays(4)
    acc = build_clusters(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                         cluster_size=s, device=cuda)
    nt = 256
    cid = rng.integers(0, acc.num_clusters, nt).astype(np.int32)
    v0 = acc.v0.cpu().numpy()
    o = v0[cid[:, None], rng.integers(0, s, (nt, t_lanes))].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 0.05
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.05, 4.0, (nt, t_lanes)).astype(np.float32)
    tm[::3] = np.inf
    tm.reshape(-1)[::7] = -1.0
    tm[1::5, 32:64] = -1.0
    tm[3::11] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm.reshape(-1)), t_lanes)
    cid_t = t(cid)
    pack = (cuda_ctiles.pack_tris16(acc) if option == "sub_skip"
            else cuda_ctiles.pack_tris16_t(acc))
    before = cuda_ctiles.launches
    t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid_t, **{option: True})
    assert cuda_ctiles.launches == before + 1
    assert (t_lanes, s, 1, option) in cuda_ctiles.launch_shapes
    t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, cid_t,
                                              **{option: True})
    t_d, tri_d = cuda_ctiles.tile_sweep(cuda_ctiles.pack_tris(acc), rays,
                                        cid_t)
    torch.cuda.synchronize()
    assert (tri_k != cuda_ctiles.I32_MAX).any()
    for t_x, tri_x in ((t_p, tri_p), (t_d, tri_d)):
        assert torch.equal(t_k.view(torch.int32), t_x.view(torch.int32))
        assert torch.equal(tri_k, tri_x)


def test_tile_sweep_options_uncompiled_shapes_raise(cuda):
    """An (S, T, option) without a tuned instance goes to the generic
    instance (the launch is counted as generic, the shape keyed with
    "generic"); a pack of the wrong layout still raises ValueError."""
    cid = torch.zeros((4,), dtype=torch.int32, device=cuda)
    for option, pack, t_lanes in (
            ("sub_skip", torch.zeros((2, 16, 256), device=cuda), 64),
            ("pack_t", torch.zeros((2, 128, 16), device=cuda), 256)):
        before = cuda_ctiles.generic_launches
        t_k, tri_k = cuda_ctiles.tile_sweep(
            pack, torch.zeros((4, 8, t_lanes), device=cuda), cid,
            **{option: True})
        torch.cuda.synchronize()
        assert cuda_ctiles.generic_launches == before + 1
        s = pack.shape[2] if option == "sub_skip" else pack.shape[1]
        assert (t_lanes, s, 1, option, "generic") in cuda_ctiles.launch_shapes
        assert torch.isinf(t_k).all()
        assert (tri_k == cuda_ctiles.I32_MAX).all()
    with pytest.raises(ValueError, match="16"):  # a 10-row pack
        cuda_ctiles.tile_sweep(torch.zeros((2, 10, 128), device=cuda),
                               torch.zeros((4, 8, 128), device=cuda), cid,
                               sub_skip=True)


@pytest.mark.parametrize("route", ["ctiles", "ctiles_sub_skip",
                                   "hybrid_ctiles_shadows", "perray",
                                   "ctiles_2level"])
def test_ctiles_and_perray_render_on_gpu(cuda, monkeypatch, route):
    """The ctiles backend (with sub_skip too), the hybrid shadow engine
    "ctiles", the 2-level ctiles cull (2,564 clusters of two) and perray
    (atol 1e-5: the packet cascade's tie rule) against the oracle."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=4, device=cuda)
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    cam = default_camera(cuda)
    kw = dict(backend="perray" if route == "perray" else "ctiles")
    if route == "ctiles_sub_skip":
        monkeypatch.setattr(wavefront, "CTILES_CLOSEST_KW", dict(
            wavefront.CTILES_CLOSEST_KW, sub_skip=True))
    if route == "hybrid_ctiles_shadows":
        monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW",
                            dict(engine="ctiles"))
        kw = {}
    if route == "ctiles_2level":
        kw["accel"] = build_clusters(scene.triangles, cluster_size=2)
    before = cuda_ctiles.sweep_launches
    img = wavefront.render(scene, cam, s, wave_size=1 << 11, device=cuda,
                           **kw)
    ref = oracle.render(scene, cam, s, device=cuda)
    if route == "perray":
        np.testing.assert_allclose(img, ref, atol=1e-5)
        return
    assert cuda_ctiles.sweep_launches > before
    np.testing.assert_array_equal(img, ref)


def test_kernel_reciprocal_is_the_ieee_division(cuda):
    """The closest-hit kernels invert the determinant without the division's
    range check; over every float bit pattern in its range (2^-126 <= |x| <
    2^126, about 4.2e9 values) the result has the division's bits."""
    assert cuda_ctiles.rcp_mismatches() == 0


def test_uncompiled_shapes_raise(cuda):
    """An (S, T) without a tuned instance launches the generic instance
    (counted in generic_launches; all-zero packs: every lane misses); a
    shape no instance takes (R > 1024 lanes a block) is a ValueError naming
    it."""
    cid = torch.zeros((4,), dtype=torch.int32, device=cuda)
    for s_, t_ in ((96, 64), (128, 96)):
        before = cuda_ctiles.generic_launches
        t_k, tri_k = cuda_ctiles.tile_sweep(
            torch.zeros((2, 10, s_), device=cuda),
            torch.zeros((4, 8, t_), device=cuda), cid)
        torch.cuda.synchronize()
        assert cuda_ctiles.generic_launches == before + 1
        assert torch.isinf(t_k).all() and (tri_k == cuda_ctiles.I32_MAX).all()
    pack = torch.zeros((3, 16, 128), device=cuda)
    rays = torch.zeros((4, 8, 32), device=cuda)
    cid8 = torch.zeros((32,), dtype=torch.int32, device=cuda)
    before = cuda_closest.generic_launches
    t_k, _tri = cuda_closest.block_closest(pack, rays, cid8)
    assert cuda_closest.generic_launches == before + 1
    before = cuda_anyhit.generic_launches
    occ = cuda_anyhit.block_anyhit(pack, rays, cid8)
    torch.cuda.synchronize()
    assert cuda_anyhit.generic_launches == before + 1
    assert torch.isinf(t_k).all() and not occ.any()
    slab96 = cuda_sweep.SlabTable(
        tri=torch.zeros((2, 9, 96), device=cuda),
        tri_id=torch.zeros((2, 96), dtype=torch.int32, device=cuda))
    order = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    n_cand = torch.ones((4,), dtype=torch.int32, device=cuda)
    before = dict(cuda_sweep.generic_launches)
    occ = cuda_sweep.anyhit_sweep(slab96, torch.zeros((4, 8, 64), device=cuda),
                                  order, n_cand)
    bt, bc, _bs = cuda_sweep.closest_sweep(
        slab96, torch.zeros((4, 8, 64), device=cuda), order,
        torch.zeros((4, 128), device=cuda), n_cand)
    torch.cuda.synchronize()
    assert cuda_sweep.generic_launches == {
        k: v + 1 for k, v in before.items()}
    assert not occ.any() and torch.isinf(bt).all() and (bc == -1).all()
    with pytest.raises(ValueError, match="R = 2048"):
        cuda_sweep.anyhit_sweep(slab96, torch.zeros((4, 8, 2048), device=cuda),
                                order, n_cand)


def test_wrapper_rejects_bad_inputs(cuda):
    pack = torch.zeros((2, 10, 128), device=cuda)
    rays = torch.zeros((4, 8, 64), device=cuda)
    cid = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_ctiles.tile_sweep(pack, rays, cid.long())
    with pytest.raises(ValueError):
        cuda_ctiles.tile_sweep(pack, rays[:, :, ::2], cid)
    with pytest.raises(ValueError):
        cuda_ctiles.tile_sweep(pack[:, :9], rays, cid)


def test_wavefront_equals_oracle_on_gpu(cuda):
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    s = RenderSettings(width=48, height=27, samples_per_pixel=2,
                       max_bounces=4, seed=3)
    before = cuda_ctiles.sweep_launches
    img_w = wavefront.render(scene, default_camera(cuda), s, wave_size=1 << 11,
                             device=cuda)
    assert cuda_ctiles.sweep_launches > before
    img_o = oracle.render(scene, default_camera(cuda), s, device=cuda)
    np.testing.assert_array_equal(img_w, img_o)


@pytest.mark.parametrize("block_size", [None, 64, 128])
def test_any_hit_packets_on_gpu(cuda, rng, block_size):
    """The shadow cascade on the card (the cascade stage kernel's any-hit
    fold), with its default arguments (blocks of 256, groups of 8) and with
    the renders' block sizes, against brute force."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.engine import intersect
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    tris = blob_scene(subdivisions=3, device=cuda).triangles
    acc = build_clusters(tris, cluster_size=128)
    o, d, tm = _bounce_wave(acc, 256 * 32, rng)
    kw = {} if block_size is None else dict(block_size=block_size, group_size=2)
    before = cuda_cascade.launches["cascade_stage_any"]
    occ = traverse.any_hit_packets(acc, o, d, 1e-3, tm, **kw)
    assert cuda_cascade.launches["cascade_stage_any"] > before
    t_lanes, g = (256, 8) if block_size is None else (block_size, 2)
    assert any(key[:4] == ("cascade_stage_any", t_lanes, 128, g)
               for key in cuda_cascade.launch_shapes)
    brute = intersect.any_hit(tris, o, d, 1e-3, tm)
    assert occ.any() and not occ.all()
    assert torch.equal(occ, brute)


# --- the pallas backend's sweeps and the fused cascades' block kernels ------


def _accel(cuda, s=128, subdiv=4):
    from types import SimpleNamespace

    arr = blob_room_arrays(subdiv)
    return build_clusters(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                          cluster_size=s, device=cuda)


def _bounce_wave(acc, n, rng, dead_every=7):
    """Rays that leave points near the triangles in random directions; half
    with a finite t_max, every `dead_every`-th lane dead."""
    v0 = acc.v0.cpu().numpy().reshape(-1, 3)
    v0 = v0[acc.tri_id.cpu().numpy().reshape(-1) >= 0]
    o = v0[rng.integers(0, v0.shape[0], n)]
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-2
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, np.inf, np.float32)
    tm[1::2] = rng.uniform(0.5, 15.0, n // 2).astype(np.float32)
    tm[::dead_every] = -1.0
    dev = acc.v0.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    return t(o), t(d), t(tm)


def _bits(x):
    return x.view(torch.int32)


def aim_block_at_cluster(rays, blk, tri, cid, dead_lanes=()):
    """Points every lane of ray block `blk` of a [B, 8, R] pack at a
    triangle of cluster `cid` (rows 0-8 of tri [C, >=9, S]: v0, e1, e2):
    from 0.5 in front of its centroid, along its normal, t_max (row 6) 1.
    Each such lane is occluded by the cluster; the lanes in `dead_lanes`
    get t_max = -1."""
    v0, e1, e2 = (tri[cid, k:k + 3].T for k in (0, 3, 6))      # [S, 3]
    n = torch.linalg.cross(e1, e2)
    area = n.norm(dim=1)
    slots = torch.nonzero(area > 1e-4).squeeze(1)
    pick = slots[torch.arange(rays.shape[2], device=slots.device)
                 % slots.numel()]
    nrm = n[pick] / area[pick, None]
    rays[blk, 0:3] = (v0[pick] + (e1[pick] + e2[pick]) / 3 + 0.5 * nrm).T
    rays[blk, 3:6] = -nrm.T
    rays[blk, 6] = 1.0
    rays[blk, 6, list(dead_lanes)] = -1.0


@pytest.mark.parametrize("s", [128, 64, 256])
@pytest.mark.parametrize("block_size", [64, 128, 32, 48, 96, 256, 1024])
def test_sweep_kernels_match_plain(cuda, rng, block_size, s):
    """Both pallas-backend kernels at every compiled S and at R = 32, 48
    (a half-empty warp), 64 (closest_sweep splits each visit over four warp
    groups up to here), 96, 128 (two groups), 256 and 1024 (one):
    every seventh lane dead, lanes with 0 <= t_cap < t_min (they can pass no
    test but keep their block walking), blocks with no candidate, one block
    all dead."""
    acc = _accel(cuda, s)
    slab = cuda_sweep.build_slab_table(acc)
    o, d, tm = _bounce_wave(acc, 256 * block_size, rng)
    rays, order, entry, n_cand, _perm = cuda_sweep._prep_wave(
        acc, o, d, tm, block_size, True)
    rays[:, 6, ::7] = -1.0
    rays[1::4, 6, 3::5] = 5e-4  # t_min is 1e-3
    rays[3, 6] = -1.0
    n_cand[6::9] = 0
    before = dict(cuda_sweep.launches)
    bt, bc, bs = cuda_sweep.closest_sweep(slab, rays, order, entry, n_cand)
    occ = cuda_sweep.anyhit_sweep(slab, rays, order, n_cand)
    torch.cuda.synchronize()
    assert cuda_sweep.launches["closest_sweep"] == before["closest_sweep"] + 1
    assert cuda_sweep.launches["anyhit_sweep"] == before["anyhit_sweep"] + 1
    pt, pc, ps = cuda_sweep.closest_sweep_plain(slab, rays, order, entry, n_cand)
    pocc = cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand)
    assert cuda_sweep.launches["closest_sweep"] == before["closest_sweep"] + 1
    assert (bc >= 0).float().mean() > 0.2 and occ.any() and not occ.all()
    assert torch.equal(_bits(bt), _bits(pt))
    assert torch.equal(bc, pc) and torch.equal(bs, ps)
    assert torch.equal(occ, pocc)
    assert not occ.reshape(-1)[rays[:, 6].reshape(-1) < 1e-3].any()
    for blk in (3, 6):  # all dead; no candidate
        assert torch.isinf(bt[blk]).all() and (bc[blk] == -1).all()
        assert (bs[blk] == 0).all()


def exact_tie_case(s, device):
    """Two copies of one triangle in different clusters of an S-slot slab
    (slots 5 and 9 of cluster 0, ids 40 and 12; slot 2 of cluster 1, id 3)
    and one block of 32 rays that hit it at t = 2 -> (slab, rays, order,
    entry, n_cand)."""
    v0 = np.zeros((2, s, 3), np.float32)
    e1 = np.zeros((2, s, 3), np.float32)
    e2 = np.zeros((2, s, 3), np.float32)
    tri_id = np.full((2, s), -1, np.int32)
    for c, slot, tid in ((0, 5, 40), (0, 9, 12), (1, 2, 3)):
        v0[c, slot] = (-1, -1, 0)
        e1[c, slot] = (2, 0, 0)
        e2[c, slot] = (0, 2, 0)
        tri_id[c, slot] = tid
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    slab = cuda_sweep.SlabTable(
        tri=t(np.concatenate([a.transpose(0, 2, 1) for a in (v0, e1, e2)], 1)),
        tri_id=t(tri_id))
    rays = torch.zeros((1, 8, 32), device=device)
    rays[0, 0:2] = -0.5
    rays[0, 2] = -2.0
    rays[0, 5] = 1.0
    rays[0, 6] = float("inf")
    order = torch.zeros((1, 128), dtype=torch.int32, device=device)
    order[0, 1] = 1
    entry = torch.full((1, 128), float("inf"), device=device)
    entry[0, :2] = 0.0
    n_cand = torch.tensor([2], dtype=torch.int32, device=device)
    return slab, rays, order, entry, n_cand


def test_closest_sweep_first_candidate_wins_an_exact_tie(cuda):
    """The kernel keeps the first candidate's first slot on an exact tie
    (strict t < best), as the plain version does on the CPU."""
    bt, bc, bs = cuda_sweep.closest_sweep(*exact_tie_case(64, cuda))
    assert (bt == 2.0).all() and (bc == 0).all() and (bs == 5).all()


@pytest.mark.parametrize("s", [128, 64, 256])
def test_fused_kernels_match_plain(cuda, rng, s):
    acc = _accel(cuda, s)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    o, d, tm = _bounce_wave(acc, 256 * 128, rng)
    o, d, tm, _perm, n_cand, _entry, order_g = cuda_anyhit.prepare_fused_wave(
        acc, o, d, tm, 128, True, "dir")
    rays = cuda_ctiles.pack_rays_tiles(o, d, tm, 128)
    assert int(n_cand.max()) > cuda_anyhit.GROUP
    hits = 0
    for k in (0, 1, order_g.shape[1] - 1):
        cid8 = order_g[:, k].reshape(-1).contiguous()
        before = cuda_anyhit.launches
        ref = cuda_anyhit.block_anyhit_plain(pack, rays, cid8)
        for early_skip in (False, True):
            for sub_skip in (False, True):
                occ = cuda_anyhit.block_anyhit(pack, rays, cid8,
                                               early_skip=early_skip,
                                               sub_skip=sub_skip)
                assert torch.equal(occ, ref), (k, early_skip, sub_skip)
        assert cuda_anyhit.launches == before + 4
        before = cuda_closest.launches
        pt, ptri = cuda_closest.block_closest_plain(pack, rays, cid8, True)
        qt, qtri = cuda_closest.block_closest_plain(pack, rays, cid8, False)
        assert torch.equal(_bits(qt), _bits(pt)) and torch.equal(qtri, ptri)
        for sub_skip in (False, True):
            kt, ktri = cuda_closest.block_closest(pack, rays, cid8, sub_skip)
            assert torch.equal(_bits(kt), _bits(pt)), (k, sub_skip)
            assert torch.equal(ktri, ptri), (k, sub_skip)
        assert cuda_closest.launches == before + 2
        hits += int((ptri != cuda_ctiles.I32_MAX).sum())
        torch.cuda.synchronize()
    assert hits > 1000


@pytest.mark.parametrize("s", [128, 64, 256])
@pytest.mark.parametrize("r_lanes", [64, 128, 48])
def test_anyhit_sweep_kernel_matches_plain(cuda, rng, r_lanes, s):
    """Every compiled S at R = 64, 128 and 48 (the last warp of each block
    half empty); every seventh lane dead, one block all dead, one block
    whose live lanes all hit its first candidate."""
    acc = _accel(cuda, s)
    slab = cuda_sweep.build_slab_table(acc)
    o, d, tm = _bounce_wave(acc, 128 * r_lanes, rng)
    rays, order, _entry, n_cand, _perm = cuda_sweep._prep_wave(
        acc, o, d, tm, r_lanes, True)
    rays[:, 6, ::7] = -1.0
    rays[3, 6] = -1.0
    assert int(n_cand[5]) > 1
    aim_block_at_cluster(rays, 5, slab.tri, int(order[5, 0]), dead_lanes=[1])
    before = cuda_sweep.launches["anyhit_sweep"]
    occ = cuda_sweep.anyhit_sweep(slab, rays, order, n_cand)
    assert cuda_sweep.launches["anyhit_sweep"] == before + 1
    st = {}
    pocc = cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand, stats=st)
    torch.cuda.synchronize()
    assert torch.equal(occ, pocc)
    assert occ.any() and not occ.all() and not occ[3].any()
    live = rays[5, 6] >= 0
    assert occ[5][live].all() and not occ[5][~live].any()


@pytest.mark.parametrize("t_lanes", [64, 128])
@pytest.mark.parametrize("s", [128, 64, 256])
def test_block_anyhit_kernel_matches_plain(cuda, rng, s, t_lanes):
    """Every compiled (S, T) with all four option settings; every seventh
    lane dead, one block all dead, one block whose live lanes all hit its
    first candidate."""
    acc = _accel(cuda, s)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    o, d, tm = _bounce_wave(acc, 256 * t_lanes, rng)
    o, d, tm, _perm, _nc, _entry, order_g = cuda_anyhit.prepare_fused_wave(
        acc, o, d, tm, t_lanes, True, "dir")
    rays = cuda_ctiles.pack_rays_tiles(o, d, tm, t_lanes)
    rays[:, 6, ::7] = -1.0
    rays[3, 6] = -1.0
    cid8 = order_g[:, 0].reshape(-1).contiguous()
    first = int(cid8[5 * cuda_anyhit.GROUP])
    assert first < acc.num_clusters
    aim_block_at_cluster(rays, 5, pack, first, dead_lanes=[1])
    ref = cuda_anyhit.block_anyhit_plain(pack, rays, cid8)
    before = cuda_anyhit.launches
    for early_skip in (False, True):
        for sub_skip in (False, True):
            occ = cuda_anyhit.block_anyhit(pack, rays, cid8,
                                           early_skip=early_skip,
                                           sub_skip=sub_skip)
            torch.cuda.synchronize()
            assert torch.equal(occ, ref), (early_skip, sub_skip)
    assert cuda_anyhit.launches == before + 4
    assert ref.any() and not ref.all() and not ref[3].any()
    live = rays[5, 6] >= 0
    assert ref[5][live].all() and not ref[5][~live].any()


def test_sweep_wrappers_reject_bad_inputs(cuda):
    slab = cuda_sweep.SlabTable(tri=torch.zeros((2, 9, 128), device=cuda),
                                tri_id=torch.zeros((2, 128), dtype=torch.int32,
                                                   device=cuda))
    rays = torch.zeros((4, 8, 64), device=cuda)
    order = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    entry = torch.zeros((4, 128), device=cuda)
    n_cand = torch.ones((4,), dtype=torch.int32, device=cuda)
    cuda_sweep.closest_sweep(slab, rays, order, entry, n_cand)  # well-formed
    with pytest.raises(TypeError):
        cuda_sweep.closest_sweep(slab, rays, order.long(), entry, n_cand)
    with pytest.raises(ValueError):
        cuda_sweep.closest_sweep(slab, rays, order + 2, entry, n_cand)
    with pytest.raises(ValueError):
        cuda_sweep.closest_sweep(slab, rays, order, entry[:, :64], n_cand)
    with pytest.raises(ValueError):
        cuda_sweep.anyhit_sweep(slab, rays, order, n_cand + 128)
    with pytest.raises(ValueError):
        cuda_sweep.anyhit_sweep(slab, rays, order.cpu(), n_cand)
    with pytest.raises(ValueError):
        cuda_sweep.anyhit_sweep(slab, rays[:, :, ::2], order, n_cand)


def test_fused_wrappers_reject_bad_inputs(cuda):
    pack = torch.zeros((3, 16, 128), device=cuda)
    rays = torch.zeros((4, 8, 128), device=cuda)
    cid8 = torch.zeros((32,), dtype=torch.int32, device=cuda)
    for fn in (cuda_anyhit.block_anyhit, cuda_closest.block_closest):
        fn(pack, rays, cid8 + 2)  # the dummy cluster is a valid id
        with pytest.raises(TypeError):
            fn(pack, rays, cid8.long())
        with pytest.raises(ValueError):
            fn(pack, rays, cid8 + 3)
        with pytest.raises(ValueError):
            fn(pack, rays, cid8[:24])
        with pytest.raises(ValueError):
            fn(pack[:, :10].contiguous(), rays, cid8)
        with pytest.raises(ValueError):
            fn(pack, rays, cid8.cpu())


def test_fused_and_pallas_renders_on_gpu(cuda, monkeypatch):
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    s = RenderSettings(width=48, height=27, samples_per_pixel=2,
                       max_bounces=4, seed=3)
    cam = default_camera(cuda)
    img_o = oracle.render(scene, cam, s, device=cuda)
    before = dict(cuda_sweep.launches)
    img_p = wavefront.render(scene, cam, s, wave_size=1 << 11,
                             backend="pallas", device=cuda)
    assert all(cuda_sweep.launches[k] > before[k] for k in before)
    np.testing.assert_allclose(img_p, img_o, atol=1e-5)
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", dict(
        engine="packets_fused", early_skip=True, sub_skip=True))
    monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW",
                        dict(engine="cascade_fused"))
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    # the fused cascades' stages launch the stage kernel's fused folds,
    # whose sweeps are block_anyhit's and block_closest's bodies; the
    # standalone kernels are not launched
    folds = cuda_cascade.FUSED_NAMES.values()
    before = ({k: cuda_cascade.launches[k] for k in folds},
              cuda_anyhit.launches, cuda_closest.launches)
    img_f = wavefront.render(scene, cam, s, wave_size=1 << 11, device=cuda)
    assert all(cuda_cascade.launches[k] > before[0][k] for k in folds)
    assert (cuda_anyhit.launches, cuda_closest.launches) == before[1:]
    np.testing.assert_array_equal(img_f, img_o)


# --- the worklist backend's item sweep, and the backends past the hybrid ----


def _worklist_wave(acc, rng, n, shadow, cap=96, item_budget=8,
                   super_cap=32):
    """A bounce-like wave through the worklist's sort, cull and item table:
    (tri_pack, block rays, WorkList)."""
    from path_tracer_ai_tpu_torch.accel import worklist
    from path_tracer_ai_tpu_torch.accel.traverse import pack_block_rays

    o, d, tm = _bounce_wave(acc, n, rng)
    if not shadow:
        tm = torch.where(tm >= 0, torch.inf, tm)
    blocks = worklist._prepare_blocks(acc, o, d, tm, 8, True)[:3]
    wl = worklist._build_worklist(acc, *blocks, 1e-3, cap, 4, item_budget,
                                  1 << 13, 1024, super_cap=super_cap)
    return cuda_ctiles.pack_tris(acc), pack_block_rays(*blocks, 1e-3), wl


def _item_args(cuda, rng, case, s, want_tri, n=1 << 13):
    """item_sweep's arguments: a worklist wave ("wave": S = 128, the flat
    cull; S = 2, more than 2048 clusters, the 2-level cull) or a crafted
    case of tests/test_torch_sweep_cases.py."""
    if case != "wave":
        c = cases.item_case(case, s)
        t = lambda a: torch.as_tensor(a, device=cuda)
        return (t(cases.pack(c)), t(cases.item_block_rays(c)),
                *(t(c[k]) for k in ("item_block", "ibase", "order_g",
                                    "n_cand")), c["n_items"], want_tri)
    acc = _accel(cuda, s=s)
    # these rays leave the surface in random directions: at S < 64 their
    # blocks see hundreds of clusters, so the caps are opened
    kw = {} if s >= 64 else dict(cap=1024, item_budget=64,
                                 super_cap=max(acc.num_supers, 1))
    pack, rays, wl = _worklist_wave(acc, rng, n, shadow=not want_tri, **kw)
    assert int(wl.n_items) > 0
    return (pack, rays, wl.item_block, wl.ibase, wl.order_g, wl.n_cand,
            int(wl.n_items), want_tri)


def _assert_item_sweep_matches_plain(args, generic):
    """The kernel (tuned or forced generic) against item_sweep_plain: t bit
    for bit, tri and occlusion exact over every item row, one launch (none
    at n_items 0)."""
    counter = "generic_launches" if generic else "launches"
    before = getattr(cuda_items, counter)
    if generic:
        with generic_instances():
            k = cuda_items.item_sweep(*args)
    else:
        k = cuda_items.item_sweep(*args)
    assert getattr(cuda_items, counter) == before + (args[6] > 0)
    p = cuda_items.item_sweep_plain(*args)
    torch.cuda.synchronize()
    if args[-1]:
        assert torch.equal(_bits(k[0]), _bits(p[0])) and torch.equal(k[1], p[1])
        return (k[1] != cuda_ctiles.I32_MAX).any()
    assert torch.equal(k[0], p[0])
    return k[0].any()


# the worklist waves, and every crafted case at every size of the cases
ITEM_KERNEL_CASES = [("wave", 128), ("wave", 2)] + [
    (c, s) for c in cases.ITEM_CASES for s in cases.SIZES]


@pytest.mark.parametrize("case,s", ITEM_KERNEL_CASES)
@pytest.mark.parametrize("want_tri", [True, False])
def test_item_sweep_kernel_matches_plain(cuda, rng, case, s, want_tri):
    """item_sweep (the instance its wrapper picks: tuned at S = 2 and 128,
    generic elsewhere) on a worklist wave and on the crafted cases (exact t
    ties across an item's clusters, a cluster named twice, garbage slots
    past n_cand, dead rays in live items, rays all occluded by the first
    chunk, n_items 0 and = i_cap) against item_sweep_plain."""
    args = _item_args(cuda, rng, case, s, want_tri)
    hit = _assert_item_sweep_matches_plain(args, generic=False)
    assert hit or case == "no_items"


def test_item_sweep_uncompiled_shapes_raise(cuda, rng):
    """S = 64 has no tuned instance: the generic one runs, bitwise the plain
    version; g = 2 clusters an item is a ValueError naming it."""
    acc = _accel(cuda, s=64)
    pack, rays, wl = _worklist_wave(acc, rng, 1 << 10, shadow=False)
    args = (pack, rays, wl.item_block, wl.ibase, wl.order_g, wl.n_cand,
            int(wl.n_items), True)
    before = cuda_items.generic_launches
    k = cuda_items.item_sweep(*args)
    assert cuda_items.generic_launches == before + 1
    p = cuda_items.item_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(k[0]), _bits(p[0])) and torch.equal(k[1], p[1])
    with pytest.raises(ValueError, match="g = 2"):
        cuda_items.item_sweep(pack, rays, wl.item_block, wl.ibase,
                              wl.order_g[:, :, :2].contiguous(), wl.n_cand,
                              int(wl.n_items), True)


@pytest.mark.parametrize("backend", ["worklist", "pairs", "packets"])
def test_worklist_pairs_packets_renders_on_gpu(cuda, backend):
    """Past 2048 clusters (blob subdiv 4 in clusters of two triangles: 2,564
    clusters) the default is the worklist backend, through item_sweep;
    pairs (pair tiles, slot_sweep) and packets (both packet cascades, the
    cascade stage kernel) by name. Each image equals the oracle's
    bitwise."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=4, device=cuda)
    acc = build_clusters(scene.triangles, cluster_size=2)
    assert acc.num_clusters > 2048
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    cam = default_camera(cuda)
    kw = {} if backend == "worklist" else dict(backend=backend)
    assert wavefront.resolve_backend(acc, 64, False, kw.get("backend")) \
        == backend
    before = (cuda_items.launches, cuda_ctiles.sweep_launches,
              dict(cuda_cascade.launches))
    img = wavefront.render(scene, cam, s, accel=acc, wave_size=1 << 11,
                           device=cuda, **kw)
    if backend == "worklist":
        assert cuda_items.launches > before[0]
    elif backend == "pairs":
        assert cuda_ctiles.sweep_launches > before[1]
    else:
        assert all(cuda_cascade.launches[k] > before[2][k]
                   for k in cuda_cascade.NAMES.values())
    np.testing.assert_array_equal(img, oracle.render(scene, cam, s,
                                                     device=cuda))


@pytest.mark.parametrize("route", ["pool", "virtual_mesh_2x2", "tile_devices",
                                   "render_sharded"])
def test_pool_and_mesh_render_on_gpu(cuda, route):
    """The pool scheduler and the mesh (a virtual (2, 2) mesh of the one
    card, tile_devices, the fused sharded render) at 2 spp: each image
    equals the oracle's bitwise, and slot_sweep was launched."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    cam = default_camera(cuda)
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    card = torch.device("cuda", 0)
    before = cuda_ctiles.sweep_launches
    if route == "pool":
        img = wavefront.render(scene, cam, s, scheduler="pool",
                               wave_size=1 << 9, device=cuda)
    elif route == "virtual_mesh_2x2":
        img = mesh.render_sharded_wavefront(
            scene, cam, s, mesh.make_mesh(2, 2, devices=[card] * 4),
            pix_chunk=1 << 8, compact_min_bucket=64)
    elif route == "tile_devices":
        img = wavefront.render(scene, cam, s, tile_devices=8, device=cuda)
    else:
        img = mesh.render_sharded(scene, cam, s,
                                  mesh.make_mesh(1, 1, devices=[card]))
    assert cuda_ctiles.sweep_launches > before
    np.testing.assert_array_equal(img, oracle.render(scene, cam, s,
                                                     device=cuda))


@pytest.mark.parametrize("tables", [
    dict(HYBRID_OCCLUDE_KW=dict(engine="packets", group_size=2,
                                exact_cull=6)),
    dict(HYBRID_CLOSEST_KW=dict(engine="cascade_fused", exact_cull=16),
         HYBRID_OCCLUDE_KW=dict(engine="packets_fused", early_skip=True,
                                sub_skip=True, exact_cull=16)),
])
def test_exact_cull_renders_on_gpu(cuda, monkeypatch, tables):
    """The exact cull in the hybrid packet cascade and in both fused
    cascades: the image equals the oracle's bitwise."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    for name, value in tables.items():
        monkeypatch.setattr(wavefront, name, value)
    scene = blob_scene(subdivisions=3, device=cuda)
    cam = default_camera(cuda)
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    img = wavefront.render(scene, cam, s, wave_size=1 << 11, device=cuda)
    np.testing.assert_array_equal(img, oracle.render(scene, cam, s,
                                                     device=cuda))


# --- the kslots backend's K-slot sweep and the worklist's mxu intersector ---


def _kslot_wave(acc, rng, n, k_clusters, shadow):
    """A bounce-like wave through kslots' own cull: (tri_pack, ray rows,
    cid, n_slots); overflowed and dead rays carry t_max -1."""
    from path_tracer_ai_tpu_torch.accel import kslots

    o, d, tm = _bounce_wave(acc, n, rng)
    if not shadow:
        tm = torch.where(tm >= 0, torch.inf, tm)
    tab = cuda_cull._kslots_chunk(acc, o, d, tm, 1e-3, 6, k_clusters,
                                  kslots.resolve_levels(acc, 0))
    tb = torch.where(tab["live"] & ~tab["over"], tm, -1.0)
    return (cuda_ctiles.pack_tris(acc),
            cuda_kslots.pack_rays(o, d, tb, 1e-3), tab["cid"],
            tab["n_slots"])


def _kslot_args(cuda, rng, case, s, k, want_tri, n=1 << 13):
    """kslot_sweep's arguments: a wave culled by kslots ("wave") or a
    crafted case of tests/test_torch_sweep_cases.py."""
    if case != "wave":
        c = cases.kslot_case(case, s)
        t = lambda a: torch.as_tensor(a, device=cuda)
        return (t(cases.pack(c)), t(cases.kslot_rays(c)), t(c["cid"]),
                t(c["n_slots"]), want_tri)
    args = _kslot_wave(_accel(cuda, s=s), rng, n, k, shadow=not want_tri)
    assert int(args[3].sum()) > 0
    return (*args, want_tri)


def _assert_kslot_sweep_matches_plain(args, generic):
    """The kernel (tuned or forced generic) against kslot_sweep_plain: t
    bit for bit, tri and occlusion exact, one launch."""
    counter = "generic_launches" if generic else "launches"
    before = getattr(cuda_kslots, counter)
    if generic:
        with generic_instances():
            got = cuda_kslots.kslot_sweep(*args)
    else:
        got = cuda_kslots.kslot_sweep(*args)
    assert getattr(cuda_kslots, counter) == before + 1
    want = cuda_kslots.kslot_sweep_plain(*args)
    torch.cuda.synchronize()
    if args[-1]:
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1])
        return (got[1] != cuda_ctiles.I32_MAX).any()
    assert torch.equal(got[0], want[0])
    return got[0].any()


# the kslots waves (closest K 12, shadow K 8), and every crafted case (K 6)
# at every size of the cases
KSLOT_KERNEL_CASES = [("wave", 128), ("wave", 2)] + [
    (c, s) for c in cases.KSLOT_CASES for s in cases.SIZES]


@pytest.mark.parametrize("case,s", KSLOT_KERNEL_CASES)
@pytest.mark.parametrize("want_tri,k", [(True, 12), (False, 8)])
def test_kslot_sweep_kernel_matches_plain(cuda, rng, case, s, want_tri, k):
    """kslot_sweep (the instance its wrapper picks) on a wave culled by
    kslots (S = 128, and S = 2 past 2048 clusters) and on the crafted cases
    (exact t ties across a row's slots, a cluster named twice, garbage
    slots past n_slots, dead and overflowed rays, rays all occluded by the
    first slot) against its plain version."""
    assert _assert_kslot_sweep_matches_plain(
        _kslot_args(cuda, rng, case, s, k, want_tri), generic=False)


def test_kslot_sweep_uncompiled_shapes_raise(cuda, rng):
    """S = 64 has no tuned instance: the generic one runs, bitwise the plain
    version; n_slots without a row a ray is a ValueError."""
    acc = _accel(cuda, s=64)
    args = _kslot_wave(acc, rng, 1 << 10, 12, shadow=False)
    before = cuda_kslots.generic_launches
    got = cuda_kslots.kslot_sweep(*args, True)
    assert cuda_kslots.generic_launches == before + 1
    want = cuda_kslots.kslot_sweep_plain(*args, True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    pack, rays, cid, n_slots = args
    with pytest.raises(ValueError, match="one row a ray"):
        cuda_kslots.kslot_sweep(pack, rays, cid, n_slots[:-1].contiguous(),
                                True)


def test_kslots_backend_renders_on_gpu(cuda):
    """backend="kslots" through kslot_sweep: the image equals the oracle's
    bitwise (the oracle's tie rule)."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    cam = default_camera(cuda)
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    before = cuda_kslots.launches
    img = wavefront.render(scene, cam, s, wave_size=1 << 11, device=cuda,
                           backend="kslots")
    assert cuda_kslots.launches > before
    np.testing.assert_array_equal(img, oracle.render(scene, cam, s,
                                                     device=cuda))


def test_worklist_mxu_within_jax_bounds_on_gpu(cuda, rng):
    """The worklist's mxu intersector at blocks of 64 against the exact
    intersector (item_sweep, blocks of 8) on the card: JAX's bounds (hit
    flips < 5e-3, t within rtol 5e-3, the same triangle on > 99%;
    occlusion flips < 5e-3)."""
    from path_tracer_ai_tpu_torch.accel import worklist

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)
    kw = dict(block=64, group=4, intersector="mxu")
    ex = worklist.closest_hit_worklist(acc, o, d, 1e-3, tm)
    mx = worklist.closest_hit_worklist(acc, o, d, 1e-3, tm, **kw)
    assert ex.hit.float().mean() > 0.1
    assert (ex.hit != mx.hit).float().mean() < 5e-3
    both = ex.hit & mx.hit
    torch.testing.assert_close(mx.t[both], ex.t[both], rtol=5e-3, atol=0)
    assert (mx.tri[both] == ex.tri[both]).float().mean() > 0.99
    occ_e = worklist.any_hit_worklist(acc, o, d, 1e-3, tm)
    occ_m = worklist.any_hit_worklist(acc, o, d, 1e-3, tm, **kw)
    assert (occ_e != occ_m).float().mean() < 5e-3


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_mxu_product_ignores_the_tf32_flag(cuda, rng, monkeypatch, precision):
    """The product's bits do not depend on torch's TF32 switch."""
    from path_tracer_ai_tpu_torch.accel import mxu

    g = torch.as_tensor(rng.standard_normal((16, 64, 10)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(rng.standard_normal((16, 10, 512, 4)),
                        dtype=torch.float32, device=cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    off = mxu.linear_product(g, w, precision)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    on = mxu.linear_product(g, w, precision)
    assert torch.equal(_bits(off), _bits(on))


# --- more than one card: launches on a card that is not the current one ----


@pytest.fixture
def second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch on a card that is not "
                    "the current device")
    return torch.device("cuda", 1)


def test_kernels_launch_on_a_card_that_is_not_current(second_card, rng):
    """Inputs on cuda:1 while cuda:0 is the current device: every kernel
    launches on the inputs' card and equals its plain version."""
    dev = second_card
    with torch.cuda.device(dev):
        acc = _accel(dev)
        o, d, tm = _bounce_wave(acc, 128 * 128, rng)
        # tile_sweep: each tile of 64 rays leaves its own cluster
        nt = o.shape[0] // 64
        cid = torch.as_tensor(
            rng.integers(0, acc.num_clusters, nt).astype(np.int32), device=dev)
        o_t = acc.v0[cid.long()].reshape(nt, -1, 3)[:, :64].reshape(-1, 3)
        tile = (cuda_ctiles.pack_tris(acc),
                cuda_ctiles.pack_rays_tiles(o_t + 1e-3, d, tm, 64), cid)
        slab = cuda_sweep.build_slab_table(acc)
        rays, order, entry, n_cand, _perm = cuda_sweep._prep_wave(
            acc, o, d, tm, 64, True)
        fo, fd, ftm, _perm, _nc, _entry, order_g = \
            cuda_anyhit.prepare_fused_wave(acc, o, d, tm, 128, True, "dir")
        fused = (cuda_anyhit.pack_tris_dummy(acc),
                 cuda_ctiles.pack_rays_tiles(fo, fd, ftm, 128),
                 order_g[:, 0].reshape(-1).contiguous())
        pack, wrays, wl = _worklist_wave(acc, rng, 1 << 13, shadow=False)
        items = (pack, wrays, wl.item_block, wl.ibase, wl.order_g,
                 wl.n_cand, int(wl.n_items), True)
        kslot = _kslot_wave(acc, rng, 1 << 13, 12, shadow=False) + (True,)
    pairs = [
        (cuda_ctiles.tile_sweep, cuda_ctiles.tile_sweep_plain, tile),
        (cuda_sweep.closest_sweep, cuda_sweep.closest_sweep_plain,
         (slab, rays, order, entry, n_cand)),
        (cuda_sweep.anyhit_sweep, cuda_sweep.anyhit_sweep_plain,
         (slab, rays, order, n_cand)),
        (cuda_anyhit.block_anyhit, cuda_anyhit.block_anyhit_plain, fused),
        (cuda_closest.block_closest, cuda_closest.block_closest_plain, fused),
        (cuda_items.item_sweep, cuda_items.item_sweep_plain, items),
        (cuda_kslots.kslot_sweep, cuda_kslots.kslot_sweep_plain, kslot),
    ]
    with torch.cuda.device(0):
        for kernel, plain, args in pairs:
            got = kernel(*args)
            torch.cuda.synchronize(dev)
            assert torch.cuda.current_device() == 0
            want = plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert g.device == dev, kernel.__name__
                if g.dtype == torch.float32:
                    g, w = _bits(g), _bits(w)
                assert torch.equal(g, w), kernel.__name__


@pytest.mark.parametrize("route", ["wavefront", "pallas", "fused",
                                   "tile_devices"])
def test_mesh_over_distinct_cards_equals_the_oracle(second_card, route):
    """A mesh over distinct cards ((2, 2) on four, (n, 1) on two or three)
    at 2 spp: the image equals the oracle's bitwise."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    n = min(torch.cuda.device_count(), 4)
    cards = [torch.device("cuda", i) for i in range(n)]
    shape = (2, 2) if n == 4 else (n, 1)
    scene = blob_scene(subdivisions=3, device=cards[0])
    cam = default_camera(cards[0])
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    grid = mesh.make_mesh(*shape, devices=cards)
    before = (cuda_ctiles.launches, cuda_sweep.launches["closest_sweep"])
    if route == "wavefront":
        img = mesh.render_sharded_wavefront(scene, cam, s, grid,
                                            pix_chunk=1 << 7,
                                            compact_min_bucket=64)
    elif route == "pallas":
        img = mesh.render_sharded_wavefront(scene, cam, s, grid,
                                            backend="pallas",
                                            pix_chunk=1 << 7,
                                            compact_min_bucket=64)
    elif route == "fused":
        img = mesh.render_sharded(scene, cam, s, grid)
    else:
        img = wavefront.render(scene, cam, s, tile_devices=n,
                               device=cards[0])
    if route == "pallas":
        assert cuda_sweep.launches["closest_sweep"] > before[1]
    else:
        assert cuda_ctiles.launches > before[0]
    np.testing.assert_array_equal(img, oracle.render(scene, cam, s,
                                                     device=cards[0]))


# --- the generic instances: any cluster size -------------------------------

# Cluster sizes outside (and, forced, inside) the tuned instances' sets: a
# power of two below and above them, and sizes that are not powers of two.
GENERIC_SIZES = [2, 16, 64, 96, 512]


class generic_instances:
    """Every wrapper launches its kernel's generic instance for the
    duration of the block, also where a tuned one is compiled."""

    def __enter__(self):
        from path_tracer_ai_tpu_torch import cuda_build

        self.real = real = cuda_build.launch_instance
        cuda_build.launch_instance = (
            lambda tuned, generic, dev, args, generic_args=None,
            use_generic=False: real(tuned, generic, dev, args, generic_args,
                                    use_generic=True))

    def __exit__(self, *exc):
        from path_tracer_ai_tpu_torch import cuda_build

        cuda_build.launch_instance = self.real


@pytest.mark.parametrize("t_lanes", [32, 64, 128, 48])
@pytest.mark.parametrize("s", GENERIC_SIZES + [128])
def test_tile_sweep_generic_matches_plain(cuda, rng, s, t_lanes):
    """tile_sweep's generic instance (forced, also where a tuned one
    exists) at each S and at T = 32, 64, 128 and 48 (a ragged warp), with
    one and two clusters a tile and with sub_skip and pack_t: bitwise the
    plain version, and the tuned instance where there is one."""
    acc = _accel(cuda, s)
    nt = 128
    cid = rng.integers(0, acc.num_clusters, (nt, 2)).astype(np.int32)
    v0 = acc.v0.cpu().numpy()
    o = v0[cid[:, :1], rng.integers(0, s, (nt, t_lanes))].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 0.05
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.05, 4.0, (nt, t_lanes)).astype(np.float32)
    tm[::3] = np.inf
    tm.reshape(-1)[::7] = -1.0
    tm[3::11] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm.reshape(-1)), t_lanes)
    packs = {None: cuda_ctiles.pack_tris(acc),
             "sub_skip": cuda_ctiles.pack_tris16(acc),
             "pack_t": cuda_ctiles.pack_tris16_t(acc)}
    hits = 0
    for cid_t in (t(cid[:, 0]), t(cid)):
        ref_t, ref_tri = cuda_ctiles.tile_sweep_plain(packs[None], rays, cid_t)
        tuned = cuda_ctiles.tile_sweep(packs[None], rays, cid_t)
        for option, pack in packs.items():
            kw = {option: True} if option else {}
            before = cuda_ctiles.generic_launches
            with generic_instances():
                t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid_t, **kw)
            assert cuda_ctiles.generic_launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(_bits(t_k), _bits(ref_t)), option
            assert torch.equal(tri_k, ref_tri), option
        assert torch.equal(_bits(tuned[0]), _bits(ref_t))
        assert torch.equal(tuned[1], ref_tri)
        hits += int((ref_tri != cuda_ctiles.I32_MAX).sum())
    assert hits > 0


@pytest.mark.parametrize("t_lanes", [32, 64, 128])
@pytest.mark.parametrize("s", GENERIC_SIZES + [128])
def test_fused_generic_matches_plain(cuda, rng, s, t_lanes):
    """block_closest's and block_anyhit's generic instances (forced) at each
    S and T = 32, 64, 128, with every option setting: bitwise the plain
    versions on a sorted, culled wave's first, second and last groups."""
    acc = _accel(cuda, s)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    o, d, tm = _bounce_wave(acc, 64 * t_lanes, rng)
    o, d, tm, _perm, _nc, _entry, order_g = cuda_anyhit.prepare_fused_wave(
        acc, o, d, tm, t_lanes, True, "dir")
    rays = cuda_ctiles.pack_rays_tiles(o, d, tm, t_lanes)
    hits = occluded = 0
    for k in sorted({0, 1, order_g.shape[1] - 1}):
        cid8 = order_g[:, k].reshape(-1).contiguous()
        ref = cuda_anyhit.block_anyhit_plain(pack, rays, cid8)
        pt, ptri = cuda_closest.block_closest_plain(pack, rays, cid8, True)
        before = (cuda_anyhit.generic_launches, cuda_closest.generic_launches)
        with generic_instances():
            for early_skip in (False, True):
                for sub_skip in (False, True):
                    occ = cuda_anyhit.block_anyhit(
                        pack, rays, cid8, early_skip=early_skip,
                        sub_skip=sub_skip)
                    assert torch.equal(occ, ref), (k, early_skip, sub_skip)
            for sub_skip in (False, True):
                kt, ktri = cuda_closest.block_closest(pack, rays, cid8,
                                                      sub_skip)
                assert torch.equal(_bits(kt), _bits(pt)), (k, sub_skip)
                assert torch.equal(ktri, ptri), (k, sub_skip)
        assert (cuda_anyhit.generic_launches,
                cuda_closest.generic_launches) == (before[0] + 4,
                                                   before[1] + 2)
        torch.cuda.synchronize()
        hits += int((ptri != cuda_ctiles.I32_MAX).sum())
        occluded += int(ref.sum())
    assert hits > 0 and occluded > 0


@pytest.mark.parametrize("r_lanes", [64, 48])
@pytest.mark.parametrize("s", GENERIC_SIZES + [128])
def test_sweep_generic_matches_plain(cuda, rng, s, r_lanes):
    """closest_sweep's and anyhit_sweep's generic instances (forced) at each
    S, R = 64 and 48: bitwise their plain versions, with dead lanes, blocks
    without candidates and one block all dead."""
    acc = _accel(cuda, s)
    slab = cuda_sweep.build_slab_table(acc)
    o, d, tm = _bounce_wave(acc, 128 * r_lanes, rng)
    rays, order, entry, n_cand, _perm = cuda_sweep._prep_wave(
        acc, o, d, tm, r_lanes, True)
    rays[:, 6, ::7] = -1.0
    rays[3, 6] = -1.0
    n_cand[6::9] = 0
    before = dict(cuda_sweep.generic_launches)
    with generic_instances():
        bt, bc, bs = cuda_sweep.closest_sweep(slab, rays, order, entry,
                                              n_cand)
        occ = cuda_sweep.anyhit_sweep(slab, rays, order, n_cand)
    torch.cuda.synchronize()
    assert cuda_sweep.generic_launches == {k: v + 1
                                           for k, v in before.items()}
    pt, pc, ps = cuda_sweep.closest_sweep_plain(slab, rays, order, entry,
                                                n_cand)
    pocc = cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand)
    assert (bc >= 0).any() and occ.any()
    assert torch.equal(_bits(bt), _bits(pt))
    assert torch.equal(bc, pc) and torch.equal(bs, ps)
    assert torch.equal(occ, pocc)


def test_closest_sweep_generic_first_candidate_wins_an_exact_tie(cuda):
    """The generic closest walk keeps the first candidate's first slot on an
    exact tie, across its chunks of 32 (S = 96: slots 5 and 9 lie in the
    first chunk of cluster 0, and cluster 1 ties too)."""
    with generic_instances():
        bt, bc, bs = cuda_sweep.closest_sweep(*exact_tie_case(96, cuda))
    assert (bt == 2.0).all() and (bc == 0).all() and (bs == 5).all()


@pytest.mark.parametrize("case", ["wave", *cases.ITEM_CASES])
@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("s", GENERIC_SIZES + [128])
def test_item_sweep_generic_matches_plain(cuda, rng, s, want_tri, case):
    """item_sweep's generic instance (forced) at each S, on a worklist wave
    and on the crafted cases: bitwise the plain version over every item
    row."""
    args = _item_args(cuda, rng, case, s, want_tri, n=1 << 12)
    hit = _assert_item_sweep_matches_plain(args, generic=True)
    assert hit or case == "no_items"


@pytest.mark.parametrize("case", ["wave", *cases.KSLOT_CASES])
@pytest.mark.parametrize("want_tri,k", [(True, 12), (False, 8)])
@pytest.mark.parametrize("s", GENERIC_SIZES + [128])
def test_kslot_sweep_generic_matches_plain(cuda, rng, s, want_tri, k, case):
    """kslot_sweep's generic instance (forced) at each S, on a kslots wave
    and on the crafted cases: bitwise the plain version."""
    _assert_kslot_sweep_matches_plain(
        _kslot_args(cuda, rng, case, s, k, want_tri, n=1 << 12),
        generic=True)


@pytest.mark.parametrize("route", ["main", "pallas", "worklist", "kslots",
                                   "fused"])
@pytest.mark.parametrize("s", GENERIC_SIZES)
def test_every_cluster_size_renders_on_gpu(cuda, monkeypatch, route, s):
    """render(accel=build_clusters(tris, cluster_size=S)) on each backend:
    the oracle's image, bitwise (pallas: atol 1e-5, its first-candidate tie
    rule), with the generic instances launched where S has no tuned one."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    cam = default_camera(cuda)
    st = RenderSettings(width=32, height=18, samples_per_pixel=2,
                        max_bounces=3, seed=3)
    acc = build_clusters(scene.triangles, cluster_size=s, device=cuda)
    kw = dict(accel=acc, wave_size=1 << 10, device=cuda)
    if route == "fused":
        monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW",
                            dict(engine="cascade_fused"))
        monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW",
                            dict(engine="packets_fused", early_skip=True,
                                 sub_skip=True))
    elif route != "main":
        kw["backend"] = route
        kw["block_size"] = 64
    img = wavefront.render(scene, cam, st, **kw)
    ref = oracle.render(scene, cam, st, device=cuda)
    if route == "pallas":
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(img, ref)


def test_numerics_on_the_card_equal_the_cpu(cuda, rng):
    """vec.sqrt_rn, vec.div_rn and the camera's rays give the CPU's bits on
    the card (torch.sqrt there is IEEE; a division by a Python number and
    the tangent take the paths that keep it so), and the rendered frame of
    tests/data/jax_reference.npz is the CPU's stored image bit for bit."""
    import os

    from path_tracer_ai_tpu_torch.convert import load_reference
    from path_tracer_ai_tpu_torch.core import vec
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene import camera

    x = rng.uniform(0.0, 50.0, 1 << 20).astype(np.float32)
    for fn in (vec.sqrt_rn, lambda t: vec.div_rn(t, 47),
               lambda t: vec.div_rn(t, np.pi)):
        got = fn(torch.from_numpy(x).to(cuda)).cpu().numpy()
        want = fn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    u, v = (torch.from_numpy(rng.random(4096).astype(np.float32))
            for _ in range(2))
    for fov in (20.0, 45.0, 90.0):
        cams = [camera.default_camera(dev)._replace(
            fov_deg=torch.tensor(np.float32(fov), device=dev))
            for dev in ("cpu", cuda)]
        d_cpu = camera.get_rays(cams[0], u, v, 16 / 9)[1].numpy()
        d_gpu = camera.get_rays(cams[1], u.to(cuda), v.to(cuda),
                                16 / 9)[1].cpu().numpy()
        np.testing.assert_array_equal(d_gpu.view(np.int32),
                                      d_cpu.view(np.int32))
    ref = load_reference(os.path.join(os.path.dirname(__file__), "data",
                                      "jax_reference.npz"), device=cuda)
    for rr, s in ref.settings.items():
        for name, img in (
                ("oracle", oracle.render(ref.scene, ref.camera, s,
                                         device=cuda)),
                ("main", wavefront.render(ref.scene, ref.camera, s,
                                          device=cuda))):
            np.testing.assert_array_equal(
                img.view(np.int32),
                ref.images[f"port_{name}_rr{rr}"].view(np.int32))


# --- the first-slot instances: the packet cascade's and perray's sweeps ----

def _first_tile_args(cuda, case, s, t_lanes, g):
    c = cases.first_case(case, s, t_lanes, g)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return t(cases.pack(c)), t(c["rays"]), t(c["tile_cid"])


def _assert_first_tile_matches_plain(args, generic):
    """tile_sweep(tie="slot") (tuned or forced generic) against its plain
    version: t bit for bit, tri exact, one first-slot launch."""
    counter = "generic_launches" if generic else "slot_launches"
    before = (getattr(cuda_ctiles, counter), cuda_ctiles.slot_launches)
    if generic:
        with generic_instances():
            got = cuda_ctiles.tile_sweep(*args, tie="slot")
    else:
        got = cuda_ctiles.tile_sweep(*args, tie="slot")
    assert getattr(cuda_ctiles, counter) == before[0] + 1
    assert cuda_ctiles.slot_launches == before[1] + 1
    want = cuda_ctiles.tile_sweep_plain(*args, tie="slot")
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("case", cases.FIRST_CASES)
@pytest.mark.parametrize("g", cases.FIRST_G)
@pytest.mark.parametrize("t_lanes", cases.FIRST_T)
@pytest.mark.parametrize("s", cases.SIZES)
def test_tile_sweep_first_slot_matches_plain(cuda, s, t_lanes, g, case):
    """tile_sweep's first-slot instance (tuned at (T 64, S 128) and (T 256,
    S 128), else generic) and its generic instance (forced) on the crafted
    first-slot tiles of tests/test_torch_sweep_cases.py (exact t ties
    across a tile's clusters and within one cluster, dead lanes and slots,
    misses, a cluster named twice) at S 2-512, T 1, 64, 256, G 1, 4, 8:
    bitwise the plain version; on the tie cases the oracle's instance
    gives other ids."""
    args = _first_tile_args(cuda, case, s, t_lanes, g)
    gen = cuda_ctiles.generic_launches
    got = _assert_first_tile_matches_plain(args, generic=False)
    tuned = (t_lanes, s) in ((64, 128), (256, 128))
    assert cuda_ctiles.generic_launches == gen + (not tuned)
    _assert_first_tile_matches_plain(args, generic=True)
    hit = got[1] != cuda_ctiles.I32_MAX
    assert hit.any()
    if case == "ties_within_cluster" or case.startswith("ties") and g > 1:
        oracle = cuda_ctiles.tile_sweep(*args)
        assert (oracle[1][hit] != got[1][hit]).any()


@pytest.mark.parametrize("t_lanes", [64, 256])
def test_tile_sweep_first_slot_on_a_wave(cuda, rng, t_lanes):
    """The cascade's shapes (T 64 and 256, S 128, G 8) on bounce-like blocks
    of the blob accel, their clusters the nearest by centre: bitwise the
    plain version, the tuned instance and the forced generic one."""
    acc = _accel(cuda)
    nt = 512
    o, d, tm = _bounce_wave(acc, nt * t_lanes, rng)
    rays = cuda_ctiles.pack_rays_tiles(o, d, tm, t_lanes)
    centre = ((acc.bmin + acc.bmax) / 2)
    tile_o = o.reshape(nt, t_lanes, 3).mean(1)
    cid = torch.cdist(tile_o, centre).argsort(dim=1)[:, :8].to(torch.int32)
    args = (cuda_ctiles.pack_tris(acc), rays, cid.contiguous())
    got = _assert_first_tile_matches_plain(args, generic=False)
    _assert_first_tile_matches_plain(args, generic=True)
    assert (got[1] != cuda_ctiles.I32_MAX).float().mean() > 0.05


def _first_kslot_args(cuda, case, s, k):
    c = cases.first_kslot_case(case, s, k)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return (t(cases.pack(c)), t(c["rays"]), t(c["cid"]), t(c["n_slots"]),
            True)


@pytest.mark.parametrize("case", cases.FIRST_CASES)
@pytest.mark.parametrize("k", cases.FIRST_G)
@pytest.mark.parametrize("s", cases.SIZES)
def test_kslot_sweep_first_slot_matches_plain(cuda, s, k, case):
    """kslot_sweep's first-slot closest instance (the perray sweep: every
    slot of a row live), through the instance its wrapper picks and the
    generic one (forced), on the crafted first-slot rows at S 2-512, K 1,
    4, 8: bitwise the plain version; on the tie cases the oracle's rule
    gives other ids."""
    args = _first_kslot_args(cuda, case, s, k)
    outs = []
    for generic in (False, True):
        before = (cuda_kslots.slot_launches, cuda_kslots.generic_launches)
        if generic:
            with generic_instances():
                got = cuda_kslots.kslot_sweep(*args, tie="slot")
        else:
            got = cuda_kslots.kslot_sweep(*args, tie="slot")
        assert cuda_kslots.slot_launches == before[0] + 1
        assert (cuda_kslots.generic_launches
                == before[1] + (generic or s not in (2, 128)))
        want = cuda_kslots.kslot_sweep_plain(*args, tie="slot")
        torch.cuda.synchronize()
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1])
        outs.append(got)
    hit = outs[0][1] != cuda_ctiles.I32_MAX
    assert hit.any()
    if case == "ties_within_cluster" or case.startswith("ties") and k > 1:
        oracle = cuda_kslots.kslot_sweep(*args)
        assert (oracle[1][hit] != outs[0][1][hit]).any()


@pytest.mark.parametrize("route", ["packets_b256", "packets_b64",
                                   "worklist_whole_wave", "perray"])
def test_packet_cascade_routes_render_on_gpu(cuda, monkeypatch, route):
    """The routes whose closest sweep is a first-slot kernel: the
    "packets" backend at blocks of 256 (tuned T 256) and 64, the worklist
    with its closest fallback forced onto the whole wave (cap 4,
    fallback_compact 1: the packet cascade at T 64), both through the
    cascade stage kernel's first-slot fold, and perray (the stage kernel's
    perray folds, first-slot and any-hit). Each launches its kernel and
    never the eager sweeps; packets and worklist equal the oracle's image bitwise, perray
    at atol 1e-5 (as test_ctiles_and_perray_render_on_gpu holds it)."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    eager = []
    for name in ("_packet_sweep_closest", "_packet_sweep_any"):
        monkeypatch.setattr(traverse, name, lambda *a, **k: eager.append(1))
    scene = blob_scene(subdivisions=4, device=cuda)
    s = RenderSettings(width=32, height=18, samples_per_pixel=2,
                       max_bounces=3, seed=3)
    cam = default_camera(cuda)
    kw = dict(wave_size=1 << 11, device=cuda)
    if route.startswith("packets"):
        kw.update(backend="packets", block_size=int(route[len("packets_b"):]))
    elif route == "perray":
        kw.update(backend="perray")
    else:
        kw.update(backend="worklist")
        monkeypatch.setattr(wavefront, "WORKLIST_CLOSEST_KW", dict(
            cap=4, item_budget=2, fallback_compact=1))
    before = dict(cuda_cascade.launches)
    img = wavefront.render(scene, cam, s, **kw)
    ref = oracle.render(scene, cam, s, device=cuda)
    assert not eager
    if route == "perray":
        for name in cuda_cascade.PERRAY_NAMES.values():
            assert cuda_cascade.launches[name] > before[name]
        np.testing.assert_allclose(img, ref, atol=1e-5)
        return
    assert (cuda_cascade.launches["cascade_stage_first"]
            > before["cascade_stage_first"])
    np.testing.assert_array_equal(img, ref)


# --- the cascade stage: the packet cascades' loop on the card --------------

def _cascade_run(stage, case, closest, dev):
    """The case's whole cascade through traverse._cascade_stages with
    `stage` (the wrapper, or the plain version): (carry, blk_index, final
    k)."""
    from path_tracer_ai_tpu_torch.accel import traverse

    t = lambda a: torch.as_tensor(a, device=dev)
    pack = t(cases.pack(case))
    nb, t_lanes = case["tm"].shape
    blocks = (t(case["rays"]), t(case["order_g"]), t(case["n_cand"]))
    if closest:
        blocks += (t(case["entry"]),)
        carry = (torch.full((nb, t_lanes), np.inf, device=dev),
                 torch.full((nb, t_lanes), -1, dtype=torch.int32, device=dev))
    else:
        carry = (torch.zeros((nb, t_lanes), dtype=torch.bool, device=dev),)
    ks = []

    def run(b, c, k, thr):
        out = stage(pack, b[0], b[1], b[2], c, k, thr,
                    **({"entry": b[3]} if closest else {}))
        ks.append(int(out[1]))
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, run)
    return carry, blk, ks[-1]


def _assert_same_cascade(got, want):
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", [2, 5, 8])
@pytest.mark.parametrize("t_lanes", cases.CASCADE_T)
@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("name", cases.CASCADE_CASES)
def test_cascade_stage_matches_plain(cuda, name, s, t_lanes, g, closest):
    """The stage kernel (tuned at (T 64, S 128) and (T 256, S 128), else
    generic) and its generic instance (forced), at the W its rule picks and
    at each W forced, on the crafted cascades of
    tests/test_torch_sweep_cases.py, through traverse._cascade_stages: the
    carry bit for bit, the block order and the final k of the plain
    version; one launch a stage."""
    case = cases.cascade_case(name, s, t_lanes, g)
    _assert_stage_kernel(case, closest, cuda)


class forced_split:
    """The stage kernel gives every slot w warps for the duration of the
    block (its rule, cuda_cascade.split_warps, patched)."""

    def __init__(self, w):
        self.w = w

    def __enter__(self):
        self.real = cuda_cascade.split_warps
        cuda_cascade.split_warps = lambda *a: self.w

    def __exit__(self, *exc):
        cuda_cascade.split_warps = self.real


def _assert_stage_kernel(case, closest, cuda):
    """The case's cascade through the stage kernel, tuned and generic, at
    the rule's W and at each W of cuda_cascade.SPLITS, against the plain
    version; each launch's shape key names its W."""
    from contextlib import nullcontext

    want = _cascade_run(cuda_cascade.cascade_stage_plain, case, closest,
                        cuda)
    name_k = cuda_cascade.NAMES[not closest]
    for w in (None, *cuda_cascade.SPLITS):
        for forced in (False, True):
            cuda_cascade.reset_launches()
            with (forced_split(w) if w else nullcontext()), \
                    (generic_instances() if forced else nullcontext()):
                got = _cascade_run(cuda_cascade.cascade_stage, case, closest,
                                   cuda)
            torch.cuda.synchronize()
            assert cuda_cascade.launches[name_k] > 0
            keys = list(cuda_cascade.launch_shapes)
            assert all(key[4] in cuda_cascade.SPLITS for key in keys)
            if w:
                assert {key[4] for key in keys} == {w}
            if forced:
                assert all(key[5:] == ("generic",) for key in keys)
            _assert_same_cascade(got, want)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", cases.CASCADE_G)
@pytest.mark.parametrize("name", cases.CASCADE_CASES)
def test_cascade_stage_splits_loop_cases(cuda, name, g, closest):
    """The stage cases of tests/test_torch_cascade_loop.py (S 16, blocks
    of 16 lanes: the generic instance; groups of 1, 2, 5, 8), each W."""
    _assert_stage_kernel(cases.cascade_case(name, 16, 16, g), closest, cuda)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("t_lanes", [64, 256])
@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("name", cases.SPLIT_CASES)
def test_cascade_stage_split_cases(cuda, name, s, t_lanes, g, closest):
    """The split cases (exact ties in two of a slot's W ranges, -0.0
    against +0.0, NaN t_max, dead lanes), each W, tuned and generic."""
    _assert_stage_kernel(cases.split_case(name, s, t_lanes, g), closest,
                         cuda)


@pytest.mark.parametrize("w", [None, 8])
@pytest.mark.parametrize("closest", [False, True])
def test_cascade_stage_list_overflow(cuda, rng, closest, w):
    """One stage of 2^20 blocks of one lane (the generic instance), each
    with a candidate: a thread block (at most 396 of them on an H100)
    lists more than its shared buffer holds (1,024 blocks) in a pass, so
    entries past it are appended one by one; (carry, k, act) bit for bit
    the plain version's, at the rule's W and at W 8."""
    from contextlib import nullcontext

    geo = cases.cascade_clusters(16)
    n = 1 << 20
    o, d, tm = cases._rays(rng, n, 16)
    tm[::7] = -1.0
    rays = np.concatenate([o, d, tm[:, None], np.full((n, 1), cases.T_MIN)],
                          1).astype(np.float32)[:, :, None]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    pack = t(cases.pack(geo))
    blocks = (t(rays), t(rng.integers(0, cases.CASCADE_C, (n, 2, 1))
                         .astype(np.int32)),
              t(rng.integers(1, 3, n).astype(np.int32)))
    kw = {"entry": t(np.full((n, 2), 2.94, np.float32))} if closest else {}

    def run(stage):
        carry = ((torch.full((n, 1), np.inf, device=cuda),
                  torch.full((n, 1), -1, dtype=torch.int32, device=cuda))
                 if closest else
                 (torch.zeros((n, 1), dtype=torch.bool, device=cuda),))
        k = torch.zeros((1,), dtype=torch.int32, device=cuda)
        out = stage(pack, *blocks, carry, k, n // 2, **kw)
        return (*out[0], out[1], out[2])

    want = run(cuda_cascade.cascade_stage_plain)
    assert int(want[-1].sum()) > 0 and int(want[-2]) > 0
    with forced_split(w) if w else nullcontext():
        got = run(cuda_cascade.cascade_stage)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                           _bits(y) if y.dtype == torch.float32 else y)


def test_split_rule_on_the_card(cuda):
    """The W rule on this card: the instances' resident warps, W = 1 for
    the main path's first shadow stage (65,536 blocks of 64), more for its
    tail stages."""
    warps, sms = cuda_cascade._resident_warps(cuda, 128, 64, True)
    assert warps >= 8 and sms >= 1
    assert cuda_cascade.split_warps(65536, 64, warps, sms) == 1
    assert cuda_cascade.split_warps(64, 64, warps, sms) > 1


@pytest.mark.parametrize("query", ["any", "any_exact", "closest"])
@pytest.mark.parametrize("block_size,g", [(64, 2), (64, 8), (256, 8)])
def test_packet_cascades_read_no_host_value(cuda, rng, monkeypatch, query,
                                            block_size, g):
    """any_hit_packets and closest_hit_packets on a bounce wave of the blob
    accel: the stage kernel's results are the host-stepped loop's bits
    (cascade_stage_plain sweeping through tile_sweep, one launch an
    iteration), and the query reads no value back to the host (neither
    does the exact cull: its kernel needs no live block count)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 15, rng)
    kw = dict(block_size=block_size, group_size=g)
    if query == "any_exact":
        kw["exact_cull"] = 6
    fn = (traverse.closest_hit_packets if query == "closest"
          else traverse.any_hit_packets)
    torch.cuda.synchronize()
    reads = sync.count
    got = fn(acc, o, d, 1e-3, tm, **kw)
    torch.cuda.synchronize()
    assert sync.count - reads == 0
    monkeypatch.setattr(cuda_cascade, "cascade_stage", partial(
        cuda_cascade.cascade_stage_plain, sweep=cuda_ctiles.tile_sweep))
    want = fn(acc, o, d, 1e-3, tm, **kw)
    if query == "closest":
        assert torch.equal(_bits(got.t), _bits(want.t))
        assert torch.equal(got.tri, want.tri)
        assert got.hit.any()
    else:
        assert torch.equal(got, want)
        assert 0 < got.float().mean() < 1


# --- the fused cascades' stage: their loop on the card ---------------------

def _fused_case_run(stage, case, closest, dev, **kw):
    """The crafted fused cascade through traverse._cascade_stages with
    `stage` (cuda_cascade.fused_stage or a plain version): (carry,
    blk_index, [(k out, act)] a stage)."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade, traverse
    from path_tracer_ai_tpu_torch.convert import accel_from_numpy

    t = lambda a: torch.as_tensor(a, device=dev)
    bb = np.zeros((1, 3), np.float32)
    acc = accel_from_numpy(case["bmin"], case["bmax"], case["v0"],
                           case["e1"], case["e2"], case["tri_id"], bb[0],
                           bb[0], bb, bb, bb[None], bb[None], device=dev)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    nb, t_lanes = case["tm"].shape
    blocks = (t(case["rays"]), t(case["n_cand"]))
    if closest:
        blocks += (t(case["entry"]), t(case["order_g"]))
        carry = (torch.full((nb, t_lanes), np.inf, device=dev),
                 torch.full((nb, t_lanes), cuda_ctiles.I32_MAX,
                            dtype=torch.int32, device=dev))
    else:
        blocks += (t(case["order_g"]),)
        carry = (torch.zeros((nb, t_lanes), dtype=torch.bool, device=dev),)
    err = cuda_cascade.new_error(dev)
    stages = []

    def run(b, c, k, thr):
        extra = {"entry": b[2]} if closest else {}
        out = stage(pack, b[0], b[-1], b[1], c, k, thr, err=err, **extra,
                    **kw)
        stages.append((int(out[1]), out[2].clone(),
                       tuple(x.clone() for x in out[0])))
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, run)
    cuda_cascade.raise_bad_ids(err, pack.shape[0] - 1)
    return carry, blk, stages


def _same_fused(got, want):
    for x, y in zip(got[0], want[0]):
        assert torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                           _bits(y) if y.dtype == torch.float32 else y)
    assert torch.equal(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
        for x, y in zip(a[2], b[2]):
            assert torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                               _bits(y) if y.dtype == torch.float32 else y)


FUSED_STAGE_OPTIONS = {False: [dict(), dict(early_skip=True, sub_skip=True),
                               dict(early_skip=True), dict(sub_skip=True)],
                       True: [dict(), dict(sub_skip=False)]}


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("t_lanes", cases.FUSED_T)
@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("name", cases.FUSED_CASES)
def test_fused_stage_matches_plain(cuda, name, s, t_lanes, closest):
    """The fused stage kernel (one instance, S and T at run time) on the
    crafted fused cascades, through traverse._cascade_stages: at every
    stage carry, k and act bit for bit those of the plain version (eager
    sweeps) and of the host-stepped loop (block_anyhit / block_closest
    launched on the card once an iteration); one launch a stage."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    case = cases.fused_cascade_case(name, s, t_lanes)
    plain = (cuda_closest.block_closest_plain if closest
             else cuda_anyhit.block_anyhit_plain)
    name_k = cuda_cascade.FUSED_NAMES[not closest]
    for kw in FUSED_STAGE_OPTIONS[closest]:
        eager = _fused_case_run(partial(
            cuda_cascade.fused_stage_plain,
            sweep=lambda *a, **k: plain(*a, **k)), case, closest, cuda, **kw)
        stepped = _fused_case_run(cuda_cascade.fused_stage_plain, case,
                                  closest, cuda, **kw)
        _same_fused(stepped, eager)
        cuda_cascade.reset_launches()
        got = _fused_case_run(cuda_cascade.fused_stage, case, closest, cuda,
                              **kw)
        torch.cuda.synchronize()
        assert cuda_cascade.launches[name_k] == len(got[2])
        assert set(cuda_cascade.launch_shapes) == {
            (name_k, t_lanes, s, 8, 1, "generic")}
        _same_fused(got, eager)


@pytest.mark.parametrize("closest", [False, True])
def test_fused_stage_bad_id_raises(cuda, closest):
    """An id outside [0, C] in a swept group: the cascade raises
    ValueError once it is done, and a stage called on the card without
    the cascade's error words raises at once."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    for s, t_lanes in ((128, 128), (16, 64)):
        case = cases.fused_cascade_case("small_nb", s, t_lanes, bad_id=True)
        with pytest.raises(ValueError, match=r"outside \[0, 13\]"):
            _fused_case_run(cuda_cascade.fused_stage, case, closest, cuda)

    def no_err(*a, err=None, **kw):
        return cuda_cascade.fused_stage(*a, **kw)

    with pytest.raises(ValueError, match="needs err"):
        _fused_case_run(no_err, case, closest, cuda)


@pytest.mark.parametrize("s", [32, 64, 128])
def test_closest_gate_keeps_a_corner_hit_on_the_card(cuda, s):
    """block_closest on the crafted corner ray (gate_corner_case: its hit
    lies past its box's f32 slab entry by more than 2^-16 of t), tuned (S
    64, 128) and generic: with sub_skip the bits of the plain version,
    which votes over the block, and of the ungated sweep; lane 0 gets the
    triangle."""
    from contextlib import nullcontext

    from path_tracer_ai_tpu_torch.convert import accel_from_numpy

    case = cases.gate_corner_case(64, s)
    bb = np.zeros((1, 3), np.float32)
    acc = accel_from_numpy(case["bmin"], case["bmax"], case["v0"],
                           case["e1"], case["e2"], case["tri_id"], bb[0],
                           bb[0], bb, bb, bb[None], bb[None], device=cuda)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    rays = torch.as_tensor(case["rays"], device=cuda)
    cid8 = torch.as_tensor(case["cid8"], device=cuda)
    want = cuda_closest.block_closest_plain(pack, rays, cid8, True)
    ungated = cuda_closest.block_closest_plain(pack, rays, cid8, False)
    assert int(want[1][0, 0]) == 7
    for forced in (False, True):
        with generic_instances() if forced else nullcontext():
            got = cuda_closest.block_closest(pack, rays, cid8, sub_skip=True)
        for w in (want, ungated):
            assert torch.equal(got[1], w[1])
            assert torch.equal(_bits(got[0]), _bits(w[0]))


@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize("s", [32, 128])
def test_closest_gate_at_a_grazing_angle_on_the_card(cuda, s, rescue):
    """block_closest on the port's crafted grazing ray (grazing_case: the
    gate skips its hit at the window's end, a standing deviation), tuned
    (S 128) and generic, alone in its block and beside a lane whose gate
    passes: the plain version's bits; lane 0 keeps no hit."""
    from contextlib import nullcontext

    from path_tracer_ai_tpu_torch.convert import accel_from_numpy

    case = cases.grazing_case("port", rescue, 128, s)
    bb = np.zeros((1, 3), np.float32)
    acc = accel_from_numpy(case["bmin"], case["bmax"], case["v0"],
                           case["e1"], case["e2"], case["tri_id"], bb[0],
                           bb[0], bb, bb, bb[None], bb[None], device=cuda)
    pack = cuda_anyhit.pack_tris_dummy(acc)
    rays = torch.as_tensor(case["rays"], device=cuda)
    cid8 = torch.as_tensor(case["cid8"], device=cuda)
    want = cuda_closest.block_closest_plain(pack, rays, cid8, True)
    assert not torch.isfinite(want[0][0, 0])
    for forced in (False, True):
        with generic_instances() if forced else nullcontext():
            got = cuda_closest.block_closest(pack, rays, cid8, sub_skip=True)
        assert torch.equal(got[1], want[1])
        assert torch.equal(_bits(got[0]), _bits(want[0]))


@pytest.mark.parametrize("query", ["any", "any_skips", "any_exact",
                                   "closest", "closest_unsorted",
                                   "closest_exact"])
def test_fused_cascades_read_one_host_value(cuda, rng, monkeypatch, query):
    """any_hit_fused and closest_hit_fused on a bounce wave of the blob
    accel (S 128, blocks of 128): the stage kernel's
    results are the host-stepped loop's bits (fused_stage_plain sweeping
    through block_anyhit / block_closest, one launch an iteration), and
    the cascade reads one value back to the host, the candidate ids'
    range check (the exact cull reads none: its kernel needs no live
    block count)."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 15, rng)
    kw = {"any": {}, "any_skips": dict(early_skip=True, sub_skip=True),
          "any_exact": dict(exact_cull=16), "closest": {},
          "closest_unsorted": dict(sort=False),
          "closest_exact": dict(exact_cull=16)}[query]
    fn = (cuda_closest.closest_hit_fused if query.startswith("closest")
          else cuda_anyhit.any_hit_fused)
    torch.cuda.synchronize()
    reads = sync.count
    fused = lambda: sum(cuda_cascade.launches[k]
                        for k in cuda_cascade.FUSED_NAMES.values())
    before = fused()
    got = fn(acc, o, d, 1e-3, tm, **kw)
    torch.cuda.synchronize()
    assert sync.count - reads == 1
    assert fused() > before
    monkeypatch.setattr(cuda_cascade, "fused_stage",
                        cuda_cascade.fused_stage_plain)
    launched = cuda_anyhit.launches + cuda_closest.launches
    want = fn(acc, o, d, 1e-3, tm, **kw)
    assert cuda_anyhit.launches + cuda_closest.launches > launched
    if query.startswith("closest"):
        assert torch.equal(_bits(got.t), _bits(want.t))
        assert torch.equal(got.tri, want.tri)
        assert got.hit.any()
    else:
        assert torch.equal(got, want)
        assert 0 < got.float().mean() < 1


def test_fused_closest_sweep_set_on_the_card(cuda):
    """The crafted scene on which the sweep set decides an exact tie: the
    card takes the copy's smaller id, as the CPU and brute force do."""
    from path_tracer_ai_tpu_torch.convert import accel_from_numpy

    sc = cases.fused_tie_scene()
    t = lambda a: torch.as_tensor(a, device=cuda)
    acc = accel_from_numpy(*sc["accel"], device=cuda)
    got = cuda_closest.closest_hit_fused(acc, t(sc["o"]), t(sc["d"]),
                                         sc["t_min"], t(sc["tm"]),
                                         sort=False)
    assert int(got.tri[0]) == 10 and float(got.t[0]) == float(sc["t"])
    assert not bool(got.hit[128])


# --- the perray stage: the perray queries' loop on the card ----------------

def _perray_run(stage, case, closest, dev):
    """The crafted perray cascade through traverse._cascade_stages
    (min_blocks as the crafted cases') with `stage`: (carry, blk_index,
    [(k out, act, carry)] a stage)."""
    from path_tracer_ai_tpu_torch.accel import traverse

    t = lambda a: torch.as_tensor(a, device=dev)
    pack = t(cases.pack(case))
    n = case["n_cand"].shape[0]
    blocks = (t(case["rays"]), t(case["order_g"]), t(case["n_cand"]))
    carry = ((torch.full((n, 1), np.inf, device=dev),
              torch.full((n, 1), -1, dtype=torch.int32, device=dev))
             if closest else
             (torch.zeros((n, 1), dtype=torch.bool, device=dev),))
    stages = []

    def run(b, c, k, thr):
        out = stage(pack, b[0], b[1], b[2], c, k, thr)
        stages.append((int(out[1]), out[2].clone(),
                       tuple(x.clone() for x in out[0])))
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, run,
                                          min_blocks=cases.PERRAY_MIN_BLOCKS)
    return carry, blk, stages


def _eager_perray(any_hit):
    """perray_stage_plain sweeping through kslot_sweep's plain version
    (eager torch on the card)."""
    from functools import partial

    def sweep(pack, rays, cid):
        n_slots = torch.full((rays.shape[0],), cid.shape[1],
                             dtype=torch.int32, device=rays.device)
        return cuda_kslots.kslot_sweep_plain(
            pack, rays, cid, n_slots, not any_hit,
            **({} if any_hit else {"tie": "slot"}))

    return partial(cuda_cascade.perray_stage_plain, sweep=sweep)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", cases.PERRAY_G)
@pytest.mark.parametrize("s", cases.PERRAY_S)
@pytest.mark.parametrize("name", cases.PERRAY_CASES)
def test_perray_stage_matches_plain(cuda, name, s, g, closest):
    """The perray stage kernel (one instance, S at run time) on the
    crafted perray cascades, through traverse._cascade_stages: at every
    stage carry, k and act bit for bit those of the plain version (eager
    sweeps) and of the host-stepped loop (kslot_sweep launched once an
    iteration); one launch a stage."""
    case = cases.perray_case(name, s, g)
    name_k = cuda_cascade.PERRAY_NAMES[not closest]
    eager = _perray_run(_eager_perray(not closest), case, closest, cuda)
    stepped = _perray_run(cuda_cascade.perray_stage_plain, case, closest,
                          cuda)
    _same_fused(stepped, eager)
    cuda_cascade.reset_launches()
    got = _perray_run(cuda_cascade.perray_stage, case, closest, cuda)
    torch.cuda.synchronize()
    assert cuda_cascade.launches[name_k] == len(got[2]) == 4
    assert set(cuda_cascade.launch_shapes) == {
        (name_k, 1, s, g, 1, "generic")}
    _same_fused(got, eager)


@pytest.mark.parametrize("query", ["any", "closest"])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_perray_queries_read_one_host_value(cuda, rng, monkeypatch, query, g):
    """closest_hit_perray and any_hit_perray on a 2^14-ray bounce wave of
    the blob accel (cap 64: no ray overflows; cap 8: some do, and go to the
    packet fallback): every stage of the stage kernel and the whole query
    bit for bit the host-stepped loop's (perray_stage_plain sweeping
    through kslot_sweep) and the plain version's (eager sweeps); the query
    reads one value back to the host, the overflow count."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    fn = (traverse.closest_hit_perray if query == "closest"
          else traverse.any_hit_perray)
    for cap in (64, 8):
        kw = dict(cap=cap, group_size=g)
        runs = {}
        for label, stage in (
                ("kernel", cuda_cascade.perray_stage),
                ("stepped", cuda_cascade.perray_stage_plain),
                ("eager", _eager_perray(query == "any"))):
            stages = []

            def spy(*a, _stage=stage):
                k_in = int(a[5])
                out = _stage(*a)
                stages.append((k_in, int(out[1]), out[2].clone(),
                               tuple(x.clone() for x in out[0])))
                return out

            monkeypatch.setattr(cuda_cascade, "perray_stage", spy)
            torch.cuda.synchronize()
            reads = sync.count
            out = fn(acc, o, d, 1e-3, tm, **kw)
            torch.cuda.synchronize()
            if label == "kernel":
                # the overflow count only (and the fallback's none)
                assert sync.count - reads == 1
            runs[label] = (out, stages)
        monkeypatch.undo()
        got = runs["kernel"]
        assert len(got[1]) == 5  # 2^14 rays: stages down to 1,024
        for other in ("stepped", "eager"):
            want = runs[other]
            if query == "closest":
                assert torch.equal(_bits(got[0].t), _bits(want[0].t))
                assert torch.equal(got[0].tri, want[0].tri)
            else:
                assert torch.equal(got[0], want[0])
            assert len(got[1]) == len(want[1])
            for a, b in zip(got[1], want[1]):
                assert a[:2] == b[:2] and torch.equal(a[2], b[2])
                for x, y in zip(a[3], b[3]):
                    assert torch.equal(
                        _bits(x) if x.dtype == torch.float32 else x,
                        _bits(y) if y.dtype == torch.float32 else y)
        hits = got[0].hit if query == "closest" else got[0]
        assert 0 < hits.float().mean() < 1


def test_perray_stage_checks_and_failed_launch_raise(cuda, monkeypatch):
    """perray_stage refuses blocks of more than one ray (ValueError) and
    raises RuntimeError when its launch reports an error: there is no
    fallback."""
    from path_tracer_ai_tpu_torch import cuda_build

    case = cases.perray_case("exhausted", 128, 4)
    t = lambda a: torch.as_tensor(a, device=cuda)
    pack, rays = t(cases.pack(case)), t(case["rays"])
    order_g, n_cand = t(case["order_g"]), t(case["n_cand"])
    n = n_cand.shape[0]
    k = torch.zeros((1,), dtype=torch.int32, device=cuda)
    occ = (torch.zeros((n, 1), dtype=torch.bool, device=cuda),)
    with pytest.raises(ValueError, match="perray_stage_any"):
        cuda_cascade.perray_stage(pack, rays.expand(n, 8, 2).contiguous(),
                                  order_g, n_cand,
                                  (torch.zeros((n, 2), dtype=torch.bool,
                                               device=cuda),), k, 0)
    monkeypatch.setattr(cuda_build, "launch", lambda *a: 9)
    with pytest.raises(RuntimeError, match="perray_stage launch failed"):
        cuda_cascade.perray_stage(pack, rays, order_g, n_cand, occ, k, 0)


# --- ctiles' dynamic bounds: block_cull and slot_sweep ---------------------

SLOT_OUT = ("closest", "any", "slot")


def _slot_args(case, dev, option):
    """(pack, rays, slot_ref, slot_cid, n_tiles) of a crafted slot case on
    the card, the pack in the option's layout."""
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    acc = SimpleNamespace(v0=t(case["v0"]), e1=t(case["e1"]),
                          e2=t(case["e2"]), tri_id=t(case["tri_id"]))
    pack = {None: cuda_ctiles.pack_tris, "sub_skip": cuda_ctiles.pack_tris16,
            "pack_t": cuda_ctiles.pack_tris16_t}[option](acc)
    return (pack, t(case["rays"]), t(case["slot_ref"]), t(case["slot_cid"]),
            torch.tensor([case["n_tiles"]], dtype=torch.int32, device=dev))


def _same_out(got, want):
    if len(got) == 1:
        return torch.equal(got[0], want[0])
    return (torch.equal(_bits(got[0]), _bits(want[0]))
            and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("option", [None, "sub_skip", "pack_t"])
@pytest.mark.parametrize("out", SLOT_OUT)
@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("shape", cases.SLOT_SHAPES)
@pytest.mark.parametrize("name", cases.SLOT_CASES)
def test_slot_sweep_matches_plain(cuda, name, shape, s, out, option,
                                  generic):
    """slot_sweep on the crafted slot tables (exact ties across a row's
    clusters, a hit at exactly t_min, -0.0 against +0.0, a row's pairs over
    several tiles, padding slots and dead rows, n_tiles 0), each output
    mode, option and instance (the options and S = 16 have only the
    generic one): bitwise its plain version (eager tile_sweep_plain), and
    the plain version through the tile_sweep kernel (the chunked form of
    before)."""
    tb, b = shape
    case = cases.slot_case(name, s, tb, b)
    args = _slot_args(case, cuda, option)
    kw = dict(tile_slots=tb, cap=case["cap"], out=out, cid_stride=tb,
              sub_skip=option == "sub_skip", pack_t=option == "pack_t")
    before = cuda_ctiles.sweep_launches
    if generic:
        with generic_instances():
            got = cuda_ctiles.slot_sweep(*args, **kw)
    else:
        got = cuda_ctiles.slot_sweep(*args, **kw)
    assert cuda_ctiles.sweep_launches == before + 1
    want = cuda_ctiles.slot_sweep_plain(
        *args, **kw, tile_chunk=2, sweep=cuda_ctiles.tile_sweep_plain)
    stepped = cuda_ctiles.slot_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _same_out(got, want) and _same_out(stepped, want)
    if out == "closest" and name == "signed_zero":
        assert (got[0] == 0).all() and not torch.signbit(got[0]).any()


def test_slot_sweep_checks_raise(cuda):
    case = cases.slot_case("ties", 128, 16, 8)
    pack, rays, ref, cid, n = _slot_args(case, cuda, None)
    kw = dict(tile_slots=16, cap=case["cap"], out="closest", cid_stride=16)
    with pytest.raises(ValueError):
        cuda_ctiles.slot_sweep(pack, rays, ref[:-1].contiguous(), cid, n,
                               **kw)
    with pytest.raises(ValueError):
        cuda_ctiles.slot_sweep(pack, rays, ref, cid, n.to(torch.int64), **kw)
    with pytest.raises(ValueError):
        cuda_ctiles.slot_sweep(pack, rays, ref, cid, n,
                               **{**kw, "out": "first"})


def _cull_blocks(acc, rng, n, b, n_live, on_faces=False):
    """Sorted ray blocks of a bounce wave (dead rays last); with on_faces,
    a quarter of the rays axis-parallel from a box face's plane (0 * inf
    in the slab test)."""
    from path_tracer_ai_tpu_torch.accel import worklist

    o, d, tm = _bounce_wave(acc, n, rng, dead_every=n + 1)
    if on_faces:
        q = n // 4
        idx = torch.randint(0, acc.num_clusters, (q,), device=o.device,
                            generator=torch.Generator(o.device).manual_seed(3))
        o[:q] = acc.bmin[idx]
        d[:q] = 0.0
        d[:q, 0] = 1.0
    tm[n_live:] = -1.0
    return worklist._prepare_blocks(acc, o, d, tm, b, True, "octorig")[:3]


@pytest.mark.parametrize("on_faces", [False, True])
@pytest.mark.parametrize("cap", [1, 4, 48])
@pytest.mark.parametrize("b", [8, 4])
@pytest.mark.parametrize("live", [None, 0, 1, 37, "all"])
def test_block_cull_matches_plain(cuda, rng, live, b, cap, on_faces):
    """block_cull against its plain version (the eager _ray_masks and
    _extract_order_flat): order, n_cand and over exact, at every live-block
    count (None: every block), caps that overflow all or few blocks, rays
    on box faces."""
    acc = _accel(cuda)
    n = 1 << 13
    nb = n // b
    n_blocks = nb if live in (None, "all") else live
    # the wave's live rays fill n_blocks blocks, the last one half
    n_live = n if n_blocks == nb else max(0, n_blocks * b - b // 2)
    blocks = _cull_blocks(acc, rng, n, b, n_live, on_faces)
    lb = None if live is None else torch.tensor(
        [n_blocks], dtype=torch.int32, device=cuda)
    before = cuda_ctiles.cull_launches
    got = cuda_ctiles.block_cull(acc, *blocks, 1e-3, cap, lb)
    assert cuda_ctiles.cull_launches == before + 1
    want = cuda_ctiles.block_cull_plain(acc, *blocks, 1e-3, cap, lb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if live is None and cap == 48:
        assert got[1].float().mean() > 1


def test_block_cull_reads_the_bound_on_the_card(cuda, rng):
    """The live-block count is read in device memory: blocks past it get
    the empty set whatever their rays."""
    acc = _accel(cuda)
    blocks = _cull_blocks(acc, rng, 1 << 12, 8, 1 << 12)
    lb = torch.tensor([5], dtype=torch.int32, device=cuda)
    order, n_cand, over = cuda_ctiles.block_cull(acc, *blocks, 1e-3, 48, lb)
    full = cuda_ctiles.block_cull(acc, *blocks, 1e-3, 48, None)
    torch.cuda.synchronize()
    assert torch.equal(n_cand[:5], full[1][:5]) and n_cand[5:].eq(0).all()
    assert (order[5:] == acc.num_clusters - 1).all() and not over[5:].any()
    assert full[1][5:].sum() > 0


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("kw", [dict(), dict(sub_skip=True),
                                dict(pallas_pack_t=True), dict(cap=4),
                                dict(block=4, tile_blocks=16)])
def test_ctiles_reads_no_host_value(cuda, rng, query, kw):
    """closest_hit_ctiles / any_hit_ctiles at levels=1 on a bounce wave:
    no host read from accel.ctiles (the overflow fallback's count stays),
    and the bits of the parent's form, the same calls through the host
    (the eager cull and the chunked tile_sweep)."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import ctiles
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    fn = (ctiles.closest_hit_ctiles if query == "closest"
          else ctiles.any_hit_ctiles)
    torch.cuda.synchronize()
    sync.reset()
    got = fn(acc, o, d, 1e-3, tm, levels=1, **kw)
    torch.cuda.synchronize()
    assert not [k for k in sync.sites if ".accel.ctiles:" in k]
    with mock.patch.object(cuda_ctiles, "block_cull",
                           cuda_ctiles.block_cull_plain), \
            mock.patch.object(cuda_ctiles, "slot_sweep",
                              cuda_ctiles.slot_sweep_plain):
        want = fn(acc, o, d, 1e-3, tm, levels=1, **kw)
    if query == "closest":
        assert torch.equal(_bits(got.t), _bits(want.t))
        assert torch.equal(got.tri, want.tri) and got.hit.any()
    else:
        assert torch.equal(got, want) and 0 < got.float().mean() < 1


@pytest.mark.parametrize("query", ["closest", "any"])
def test_pairs_read_only_the_fallback_count(cuda, rng, query):
    """closest_hit_pairs / any_hit_pairs: the sweep reads its tile count on
    the card; the one host read left is the overflow count."""
    from path_tracer_ai_tpu_torch.accel import pairs
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)
    fn = pairs.closest_hit_pairs if query == "closest" else pairs.any_hit_pairs
    torch.cuda.synchronize()
    sync.reset()
    before = cuda_ctiles.sweep_launches
    got = fn(acc, o, d, 1e-3, tm, cap=8)
    torch.cuda.synchronize()
    assert cuda_ctiles.sweep_launches == before + 1
    sites = [k for k in sync.sites if ".accel.pairs:" in k]
    assert len(sites) == 1 and sync.sites[sites[0]] == 1
    cpu = fn(acc.to("cpu"), o.cpu(), d.cpu(), 1e-3, tm.cpu(), cap=8)
    if query == "closest":  # the card's bits are the CPU's
        assert torch.equal(_bits(got.t.cpu()), _bits(cpu.t))
        assert torch.equal(got.tri.cpu(), cpu.tri)
    else:
        assert torch.equal(got.cpu(), cpu)


# --- the packet cascades' interval cull: packet_cull -----------------------

# (blocks, rays a block, clusters) beyond the CPU tests' sizes: the main
# path's R and C, the worklist's C, R past a thread block, one ray and one
# cluster, the largest C sorted in shared memory and the first past it,
# and C at the edges of the one-warp sorts (32 and 64 finite entries)
CULL_CARD_SIZES = cases.CULL_SIZES + ((256, 64, 641), (16, 256, 2561),
                                      (4, 1024, 700), (3, 1, 1),
                                      (8, 32, 16384), (6, 32, 16385),
                                      (4, 8, 32), (4, 8, 33), (4, 8, 64),
                                      (4, 8, 65))


def _cull_args(case, dev):
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(a, device=dev)
    acc = SimpleNamespace(bmin=t(case["bmin"]), bmax=t(case["bmax"]),
                          num_clusters=case["bmin"].shape[0])
    return acc, t(case["o"]), t(case["d"]), t(case["tm"])


def _same_cull(got, want) -> bool:
    """order and n_cand identical, entry_sorted equal as values (-0.0 ==
    +0.0, no NaN)."""
    ok = (torch.equal(got[0].cpu(), want[0].cpu())
          and torch.equal(got[1].cpu(), want[1].cpu()))
    if want[2] is None:
        return ok and got[2] is None
    return ok and bool((got[2].cpu() == want[2].cpu()).all())


@pytest.mark.parametrize("with_entry", [True, False])
@pytest.mark.parametrize("nb,r,c", CULL_CARD_SIZES)
@pytest.mark.parametrize("name", cases.CULL_CASES)
def test_packet_cull_matches_plain(cuda, name, nb, r, c, with_entry):
    """packet_cull on the crafted cull cases against its plain version on
    the same inputs (run on the CPU, where the tests hold it against the
    JAX package)."""
    case = cases.cull_case(name, nb, r, c)
    before = cuda_cull.launches
    got = cuda_cull.block_candidates(*_cull_args(case, cuda), with_entry)
    assert cuda_cull.launches == before + 1
    want = cuda_cull.block_candidates_plain(*_cull_args(case, "cpu"),
                                            with_entry)
    torch.cuda.synchronize()
    assert _same_cull(got, want)


def test_packet_cull_matches_plain_on_the_card(cuda, rng):
    """A bounce wave of the blob accel in sorted blocks of 64: the kernel
    against the plain version run on the card."""
    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    o, d, tm, _perm = traverse._sort_rays(acc, o, d, tm, "dir")
    blk = (o.reshape(-1, 64, 3).contiguous(),
           d.reshape(-1, 64, 3).contiguous(), tm.reshape(-1, 64).contiguous())
    got = cuda_cull.block_candidates(acc, *blk)
    want = cuda_cull.block_candidates_plain(acc, *blk)
    torch.cuda.synchronize()
    assert _same_cull(got, want) and got[1].float().mean() > 1


@pytest.mark.parametrize("route", ["any_hit_packets", "closest_hit_packets",
                                   "pallas_any", "pallas_closest",
                                   "fused_any", "fused_closest", "exact"])
def test_packet_cull_on_every_caller(cuda, rng, route):
    """Each caller of traverse._block_candidates on the card launches the
    kernel (once; the exact cull's conservative list too) and never its
    plain version, and asks for the entries only where it reads them; the
    result is the CPU's."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 12, rng)
    cpu = acc.to("cpu")
    wants_entry = {"any_hit_packets": False, "closest_hit_packets": True,
                   "pallas_any": False, "pallas_closest": True,
                   "fused_any": False, "fused_closest": True,
                   "exact": True}[route]

    def run(a, o_, d_, tm_):
        if route == "any_hit_packets":
            return traverse.any_hit_packets(a, o_, d_, 1e-3, tm_,
                                            block_size=64, group_size=2)
        if route == "closest_hit_packets":
            return traverse.closest_hit_packets(a, o_, d_, 1e-3, tm_,
                                                block_size=64).t
        if route == "exact":
            return traverse.any_hit_packets(a, o_, d_, 1e-3, tm_,
                                            block_size=64, exact_cull=6)
        if route.startswith("pallas"):
            return cuda_sweep._prep_wave(a, o_, d_, tm_, 64, True,
                                         with_entry=wants_entry)[1]
        return cuda_anyhit.prepare_fused_wave(
            a, o_, d_, tm_, 128, True, "dir", with_entry=wants_entry)[-1]

    seen = []
    real = cuda_cull.block_candidates

    def spy(*a, **k):
        seen.append(a[4] if len(a) > 4 else k.get("with_entry", True))
        return real(*a, **k)

    def no_plain(*a, **k):
        raise AssertionError("the plain cull ran on the card")

    before = cuda_cull.launches
    with mock.patch.object(cuda_cull, "block_candidates", spy), \
            mock.patch.object(cuda_cull, "block_candidates_plain", no_plain):
        got = run(acc, o, d, tm)
    torch.cuda.synchronize()
    assert cuda_cull.launches == before + 1 and seen == [wants_entry]
    want = run(cpu, o.cpu(), d.cpu(), tm.cpu())
    if got.dtype == torch.float32:
        assert torch.equal(_bits(got.cpu()), _bits(want))
    else:
        assert torch.equal(got.cpu(), want)


def test_packet_cull_launch_failure_raises(cuda):
    """A refused launch raises; nothing falls back to the plain version."""
    from unittest import mock

    case = cases.cull_case("coherent", 4, 16, 70)
    args = _cull_args(case, cuda)

    class Refused:
        def __call__(self, *a):
            return 1  # cudaErrorInvalidValue

    lib = cuda_cull._lib()
    with mock.patch.object(cuda_cull, "_lib", lambda: mock.Mock(
            packet_cull=Refused(),
            packet_cull_scratch_bytes=lib.packet_cull_scratch_bytes)), \
            mock.patch.object(cuda_cull, "block_candidates_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="packet_cull"):
            cuda_cull.block_candidates(*args)


def test_packet_cull_occupancy(cuda):
    occ = cuda_cull.occupancy(641)
    assert occ["registers"] > 0 and occ["warps_per_sm"] >= 8
    assert cuda_cull.occupancy(16385)["warps_per_sm"] >= 8


# --- the worklist's cull: worklist_cull; item_sweep's device count ----------

WL_BOX_KEYS = ("bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")


def _wl_case_args(case, dev):
    """(accel, o_blk, d_blk, tm_blk) of a crafted worklist-cull case."""
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(a, device=dev)
    acc = SimpleNamespace(**{k: t(case[k]) for k in WL_BOX_KEYS},
                          num_clusters=case["bmin"].shape[0],
                          num_supers=case["sbmin"].shape[0],
                          super_size=case["ss"])
    return acc, t(case["o"]), t(case["d"]), t(case["tm"])


def _wl_sizes(acc, cap, levels, super_cap, g=4):
    """(k_eff, width) of the worklist's table for these caps."""
    k = min(cap, acc.num_clusters)
    if levels == 2:
        k = min(k, min(super_cap, acc.num_supers) * acc.super_size)
    return k, -(-k // g) * g


def _same_wl_cull(got, want) -> bool:
    return all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))


WL_CULL_CARD = [(name, levels, cap_add, scap_add)
                for name in cases.WL_CULL_CASES
                for levels in cases.wl_cull_case(name)["levels"]
                for cap_add, scap_add in ((0, 0), (1, 0), (0, 1), (-3, 0))]


@pytest.mark.parametrize("name,levels,cap_add,scap_add", WL_CULL_CARD)
def test_worklist_cull_matches_plain(cuda, name, levels, cap_add, scap_add):
    """worklist_cull on the crafted worklist-cull cases, at the case's caps
    and one past each (and a cap that most blocks overflow), against its
    plain version on the same inputs run on the CPU (where the tests hold
    it against the JAX package): bit for bit, pad columns included."""
    case = cases.wl_cull_case(name)
    cap = max(case["cap"] + cap_add, 1)
    super_cap = case["super_cap"] + scap_add
    acc, *blk = _wl_case_args(case, cuda)
    k_eff, width = _wl_sizes(acc, cap, levels, super_cap)
    before = cuda_cull.worklist_launches
    got = cuda_cull.worklist_cull(acc, *blk, cap, k_eff, width, levels,
                                  super_cap)
    assert cuda_cull.worklist_launches == before + 1
    acc_c, *blk_c = _wl_case_args(case, "cpu")
    want = cuda_cull.worklist_cull_plain(acc_c, *blk_c, cap, k_eff, width,
                                         levels, super_cap)
    torch.cuda.synchronize()
    assert _same_wl_cull(got, want)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("s,b", [(2, 8), (2, 64), (128, 8), (16, 1)])
def test_worklist_cull_on_a_worklist_wave(cuda, rng, s, b, levels):
    """A bounce wave sorted into blocks as the worklist sorts them, on the
    blob accel in clusters of s (S = 2: 2,564 clusters, past 2048, so
    levels 1 is the flat cull past 2048 too), at a cap most blocks
    overflow, the route's and one none does: the kernel against the plain
    version run on the card, bit for bit, with candidates and overflow."""
    from path_tracer_ai_tpu_torch.accel import worklist

    acc = _accel(cuda, s=s)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)
    blk = [x.contiguous() for x in
           worklist._prepare_blocks(acc, o, d, tm, b, True)[:3]]
    seen_cand = seen_over = False
    for cap, super_cap in ((4, 4), (64, 32), (4096, acc.num_supers)):
        k_eff, width = _wl_sizes(acc, cap, levels, super_cap)
        got = cuda_cull.worklist_cull(acc, *blk, cap, k_eff, width, levels,
                                      super_cap)
        want = cuda_cull.worklist_cull_plain(acc, *blk, cap, k_eff, width,
                                             levels, super_cap)
        torch.cuda.synchronize()
        assert _same_wl_cull(got, want)
        seen_cand |= bool((got[1] > 0).any())
        seen_over |= bool(got[2].any())
    assert seen_cand and seen_over


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_build_worklist_launches_the_cull_kernel(cuda, rng, levels):
    """On the card _build_worklist launches worklist_cull once (levels 0
    picks 2 past 2048 clusters) and never the plain version; its tables
    are the CPU's."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import worklist

    acc = _accel(cuda, s=2)
    assert acc.num_clusters > 2048
    o, d, tm = _bounce_wave(acc, 1 << 12, rng)
    blocks = worklist._prepare_blocks(acc, o, d, tm, 8, True)[:3]
    seen = []
    real = cuda_cull.worklist_cull

    def spy(*a, **k):
        seen.append(a[7])
        return real(*a, **k)

    def no_plain(*a, **k):
        raise AssertionError("the plain cull ran on the card")

    with mock.patch.object(cuda_cull, "worklist_cull", spy), \
            mock.patch.object(cuda_cull, "worklist_cull_plain", no_plain):
        wl = worklist._build_worklist(acc, *blocks, 1e-3, 64, 4, 6, 1 << 13,
                                      1024, levels=levels)
    assert seen == [levels or 2]
    cpu = acc.to("cpu")
    want = worklist._build_worklist(cpu, *(x.cpu() for x in blocks), 1e-3,
                                    64, 4, 6, 1 << 13, 1024, levels=levels)
    for got_t, want_t in zip(wl, want):
        assert torch.equal(got_t.cpu(), want_t)


def test_worklist_cull_launch_failure_raises(cuda):
    """A refused launch raises; nothing falls back to the plain version."""
    from unittest import mock

    case = cases.wl_cull_case("cap_edge")
    args = _wl_case_args(case, cuda)

    class Refused:
        def __call__(self, *a):
            return 1  # cudaErrorInvalidValue

    with mock.patch.object(cuda_cull, "_worklist_lib", lambda: mock.Mock(
            worklist_cull=Refused())), \
            mock.patch.object(cuda_cull, "worklist_cull_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="worklist_cull"):
            cuda_cull.worklist_cull(*args, 6, 6, 8, 2)


def test_worklist_cull_occupancy(cuda):
    occ = cuda_cull.worklist_occupancy()
    assert occ["registers"] > 0 and occ["warps_per_sm"] >= 8


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("case,s", [("wave", 128), ("wave", 2)] + [
    (c, 16) for c in cases.ITEM_CASES])
def test_item_sweep_device_count_matches_host_count(cuda, rng, case, s,
                                                    want_tri, generic):
    """item_sweep reading n_items on the card (a 0-dim i32 tensor) equals
    the same call given the count as an int, bit for bit; a count past
    i_cap is read as i_cap."""
    args = list(_item_args(cuda, rng, case, s, want_tri))
    n = args[6]
    run = lambda a: cuda_items.item_sweep(*a)
    from contextlib import nullcontext

    ctx = generic_instances() if generic else nullcontext()
    with ctx:
        host = run(args)
        args[6] = torch.tensor(n, dtype=torch.int32, device=cuda)
        dev = run(args)
        args[6] = torch.tensor(args[2].shape[0] + 5, dtype=torch.int32,
                               device=cuda)
        past = run(args)
        full = run(args[:6] + [args[2].shape[0]] + args[7:])
    torch.cuda.synchronize()
    for a, b in ((host, dev), (past, full)):
        assert all(torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                               _bits(y) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b))


@pytest.mark.parametrize("query", ["closest", "any"])
def test_worklist_query_reads_one_host_value(cuda, rng, query):
    """A worklist query on the card (past 2048 clusters: the 2-level cull)
    reads one host value of its own, the overflow fallback's count: neither
    the cull nor the item sweep reads any (the pair tiles that complete the
    overflow rays read theirs, in accel.pairs); its result is the CPU's."""
    from path_tracer_ai_tpu_torch.accel import worklist
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda, s=2)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)
    fn = (worklist.closest_hit_worklist if query == "closest"
          else worklist.any_hit_worklist)
    before = cuda_cull.worklist_launches
    sync.reset()
    got = fn(acc, o, d, 1e-3, tm)
    reads = dict(sync.sites)
    torch.cuda.synchronize()
    own = {k: v for k, v in reads.items()
           if not k.startswith("path_tracer_ai_tpu_torch.accel.pairs:")}
    assert list(own.values()) == [1], reads
    assert next(iter(own)).startswith(
        "path_tracer_ai_tpu_torch.accel.worklist:"), reads
    assert cuda_cull.worklist_launches == before + 1
    want = fn(acc.to("cpu"), o.cpu(), d.cpu(), 1e-3, tm.cpu())
    if query == "closest":
        assert torch.equal(_bits(got.t.cpu()), _bits(want.t))
        assert torch.equal(got.tri.cpu(), want.tri)
    else:
        assert torch.equal(got.cpu(), want)


# --- the per-ray culls: kslots_cull, perray_cull -----------------------------

def _same_tables(got, want) -> bool:
    return (set(got) == set(want)
            and all(torch.equal(got[k].cpu(), want[k].cpu()) for k in got))


KSLOTS_CULL_CARD = [(name, levels, ks_add, kc_add)
                    for name in cases.RAY_CULL_CASES for levels in (1, 2)
                    for ks_add, kc_add in ((0, 0), (1, 0), (0, 1), (0, -3))]


@pytest.mark.parametrize("name,levels,ks_add,kc_add", KSLOTS_CULL_CARD)
def test_kslots_cull_matches_plain(cuda, name, levels, ks_add, kc_add):
    """kslots_cull on the crafted per-ray cull cases, at the case's caps,
    one past each and a k_clusters most rays overflow, against its plain
    version on the same inputs run on the CPU (where the tests hold it
    against the JAX package): bit for bit, every table."""
    case = cases.ray_cull_case(name)
    ks, kc = case["ks"] + ks_add, max(case["kc"] + kc_add, 0)
    acc, o, d, tm = _wl_case_args(case, cuda)
    before = cuda_cull.kslots_launches
    got = cuda_cull.kslots_cull(acc, o, d, tm, case["t_min"], ks, kc, levels)
    assert cuda_cull.kslots_launches == before + 1
    acc_c, *rays_c = _wl_case_args(case, "cpu")
    want = cuda_cull.kslots_cull_plain(acc_c, *rays_c, case["t_min"], ks, kc,
                                       levels)
    torch.cuda.synchronize()
    assert _same_tables(got, want)


@pytest.mark.parametrize("cap_add", [0, 1, -4, 40])
@pytest.mark.parametrize("name", cases.RAY_CULL_CASES)
def test_perray_cull_matches_plain(cuda, name, cap_add):
    """perray_cull on the crafted cases at the case's cap, one past it, a
    cap most rays overflow and one past C, against its plain version run
    on the CPU: bit for bit."""
    case = cases.ray_cull_case(name)
    cap = max(case["cap"] + cap_add, 0)
    acc, o, d, tm = _wl_case_args(case, cuda)
    before = cuda_cull.perray_launches
    got = cuda_cull.perray_cull(acc, o, d, case["t_min"], tm, cap)
    assert cuda_cull.perray_launches == before + 1
    acc_c, o_c, d_c, tm_c = _wl_case_args(case, "cpu")
    want = cuda_cull.perray_cull_plain(acc_c, o_c, d_c, case["t_min"], tm_c,
                                       cap)
    torch.cuda.synchronize()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("s", [128, 16])
def test_ray_culls_on_a_bounce_wave(cuda, rng, s, levels):
    """A bounce wave on the blob accel in clusters of s (41 clusters in 3
    supers at S 128, 321 in 21 at S 16), at caps most rays overflow and
    the routes' own: both kernels against their plain versions run on the
    card, bit for bit, with candidates and overflow."""
    acc = _accel(cuda, s=s)
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    seen_cand = seen_over = False
    for ks, kc in ((2, 4), (6, 12), (6, 8)):
        got = cuda_cull.kslots_cull(acc, o, d, tm, 1e-3, ks, kc, levels)
        want = cuda_cull.kslots_cull_plain(acc, o, d, tm, 1e-3, ks, kc,
                                           levels)
        torch.cuda.synchronize()
        assert _same_tables(got, want)
        seen_cand |= bool((got["n_slots"] > 0).any())
        seen_over |= bool(got["over"].any())
    assert seen_cand and seen_over
    if levels == 1:
        for cap in (4, 64):
            got = cuda_cull.perray_cull(acc, o, d, 1e-3, tm, cap)
            want = cuda_cull.perray_cull_plain(acc, o, d, 1e-3, tm, cap)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert bool(got[2].any()) or cap > 4


def test_queries_launch_the_ray_culls(cuda, rng):
    """On the card a kslots query launches kslots_cull once and a perray
    query (order_mode "id") perray_cull once, never the plain versions;
    their results are the CPU's."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import kslots, traverse

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 12, rng)

    def no_plain(*a, **k):
        raise AssertionError("a plain cull ran on the card")

    cpu = acc.to("cpu")
    with mock.patch.object(cuda_cull, "kslots_cull_plain", no_plain), \
            mock.patch.object(cuda_cull, "perray_cull_plain", no_plain):
        k0, p0 = cuda_cull.kslots_launches, cuda_cull.perray_launches
        hit = kslots.closest_hit_kslots(acc, o, d, 1e-3, tm)
        assert cuda_cull.kslots_launches == k0 + 1
        occ = traverse.any_hit_perray(acc, o, d, 1e-3, tm)
        assert cuda_cull.perray_launches == p0 + 1
    want_hit = kslots.closest_hit_kslots(cpu, o.cpu(), d.cpu(), 1e-3, tm.cpu())
    want_occ = traverse.any_hit_perray(cpu, o.cpu(), d.cpu(), 1e-3, tm.cpu())
    assert torch.equal(_bits(hit.t.cpu()), _bits(want_hit.t))
    assert torch.equal(hit.tri.cpu(), want_hit.tri)
    assert torch.equal(occ.cpu(), want_occ)


@pytest.mark.parametrize("which", ["kslots_cull", "perray_cull"])
def test_ray_cull_launch_failure_raises(cuda, which):
    """A refused launch raises; nothing falls back to the plain version."""
    from unittest import mock

    case = cases.ray_cull_case("count_edges")
    acc, o, d, tm = _wl_case_args(case, cuda)

    def refused(*a):
        return 1  # cudaErrorInvalidValue

    lib = mock.Mock(kslots_cull=refused, perray_cull=refused)
    with mock.patch.object(cuda_cull, "_ray_lib", lambda: lib), \
            mock.patch.object(cuda_cull, which + "_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match=which):
            if which == "kslots_cull":
                cuda_cull.kslots_cull(acc, o, d, tm, 1e-3, 2, 6, 2)
            else:
                cuda_cull.perray_cull(acc, o, d, 1e-3, tm, 6)


def test_ray_cull_occupancy(cuda):
    occ = cuda_cull.ray_occupancy()
    for name in ("kslots_cull", "perray_cull"):
        assert occ[name]["registers"] > 0 and occ[name]["warps_per_sm"] >= 8


# --- the pair tables' CULL + PACK: pair_tables ------------------------------

PAIR_FIELDS = ("pair_ray", "tile_cluster", "dst", "n_cand", "overflow",
               "n_tiles")


def _same_pairs(got, want) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))


def _pair_case_args(case, dev):
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(a, device=dev)
    acc = SimpleNamespace(bmin=t(case["bmin"]), bmax=t(case["bmax"]),
                          num_clusters=case["bmin"].shape[0])
    return acc, t(case["o"]), t(case["d"]), t(case["tm"])


def _pair_tiling(tiling):
    """Patches the pair kernels' ray tiles: the default, one ray a tile,
    three rays a tile, or the whole wave in one tile."""
    from unittest import mock

    tiles, least = {"default": (cuda_cull.PAIR_TILES,
                                cuda_cull.PAIR_MIN_TILE_RAYS),
                    "one_ray": (1 << 30, 1), "three_rays": (1 << 30, 3),
                    "one_tile": (1, 1)}[tiling]
    return mock.patch.multiple(cuda_cull, PAIR_TILES=tiles,
                               PAIR_MIN_TILE_RAYS=least)


@pytest.mark.parametrize("tiling", ["default", "one_ray", "three_rays",
                                    "one_tile"])
@pytest.mark.parametrize("cap_add", [0, 1, -3])
@pytest.mark.parametrize("name", sorted(cases.PAIR_CASES))
def test_pair_tables_match_plain(cuda, name, cap_add, tiling):
    """The pair kernels on the crafted cases at the case's cap, one past it
    and a cap most rays overflow, at several ray tilings (one ray a tile,
    three, every ray in one), against the plain version run on the CPU
    (where the tests hold it against the JAX package): every field bit for
    bit."""
    case = cases.pair_case(name)
    kw = dict(cap=max(case["cap"] + cap_add, 0),
              pair_budget=case["pair_budget"], tile_rays=case["tile_rays"],
              pair_align=case["pair_align"])
    acc, o, d, tm = _pair_case_args(case, cuda)
    before = cuda_cull.pair_launches
    with _pair_tiling(tiling):
        got = cuda_cull.pair_tables(acc, o, d, case["t_min"], tm, **kw)
    assert cuda_cull.pair_launches == before + 1
    acc_c, o_c, d_c, tm_c = _pair_case_args(case, "cpu")
    want = cuda_cull.pair_tables_plain(acc_c, o_c, d_c, case["t_min"], tm_c,
                                       **kw)
    torch.cuda.synchronize()
    assert _same_pairs(got, want)
    assert got[5].shape == () and got[5].device.type == "cuda"


@pytest.mark.parametrize("cap,budget", [(8, 1), (64, 12), (32, 8)])
@pytest.mark.parametrize("s,n", [(128, 1 << 13), (16, 1 << 15), (2, 1 << 12)])
def test_pair_tables_on_a_bounce_wave(cuda, rng, s, n, cap, budget):
    """A bounce wave on the blob accel in clusters of s (41 clusters at S
    128, 321 at S 16, and at S 2 over subdiv 6 about 41,000, past the
    running offsets' shared memory), at the fallback's cap and budget, a
    budget most rays pass and the default's: the kernels against the plain
    version run on the card, bit for bit, at two tilings."""
    acc = _accel(cuda, s=s, subdiv=6 if s == 2 else 4)
    if s == 2:
        assert acc.num_clusters > 12288
    o, d, tm = _bounce_wave(acc, n, rng)
    if s == 2:  # short rays: some within cap among 41,000 small boxes
        tm = torch.where(tm >= 0.0, torch.clamp(tm, max=0.05), tm)
    kw = dict(cap=cap, pair_budget=budget, tile_rays=128, pair_align=2)
    want = cuda_cull.pair_tables_plain(acc, o, d, 1e-3, tm, **kw)
    for tiling in ("default", "three_rays"):
        with _pair_tiling(tiling):
            got = cuda_cull.pair_tables(acc, o, d, 1e-3, tm, **kw)
        torch.cuda.synchronize()
        assert _same_pairs(got, want)
    # rays with pairs, or (a budget of one pair a ray) over the budget
    assert bool((want[3] > 0).any() or want[4].any())


def test_pair_queries_launch_the_kernels(cuda, rng):
    """On the card closest_hit_pairs, any_hit_pairs and the worklist's
    overflow fallback build their tables with the kernels (one call each),
    never the plain version; their results are the CPU's."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import pairs, worklist

    acc = _accel(cuda)
    o, d, tm = _bounce_wave(acc, 1 << 12, rng)
    over = torch.zeros(o.shape[0], dtype=torch.bool, device=cuda)
    over[::3] = True

    def no_plain(*a, **k):
        raise AssertionError("the plain pair tables ran on the card")

    cpu = acc.to("cpu")
    with mock.patch.object(cuda_cull, "pair_tables_plain", no_plain):
        p0 = cuda_cull.pair_launches
        hit = pairs.closest_hit_pairs(acc, o, d, 1e-3, tm, cap=8)
        occ = pairs.any_hit_pairs(acc, o, d, 1e-3, tm, cap=8)
        fb = worklist._overflow_fallback(acc, o, d, 1e-3, tm, over, True,
                                         4096, 64)
        assert cuda_cull.pair_launches == p0 + 3
    want_hit = pairs.closest_hit_pairs(cpu, o.cpu(), d.cpu(), 1e-3,
                                       tm.cpu(), cap=8)
    want_occ = pairs.any_hit_pairs(cpu, o.cpu(), d.cpu(), 1e-3, tm.cpu(),
                                   cap=8)
    want_fb = worklist._overflow_fallback(cpu, o.cpu(), d.cpu(), 1e-3,
                                          tm.cpu(), over.cpu(), True, 4096,
                                          64)
    assert torch.equal(_bits(hit.t.cpu()), _bits(want_hit.t))
    assert torch.equal(hit.tri.cpu(), want_hit.tri)
    assert torch.equal(occ.cpu(), want_occ)
    assert torch.equal(_bits(fb[0].cpu()), _bits(want_fb[0]))


def test_pair_tables_launch_failure_raises(cuda):
    """A refused launch raises; nothing falls back to the plain version."""
    from unittest import mock

    case = cases.pair_case("count_edges")
    acc, o, d, tm = _pair_case_args(case, cuda)

    def refused(*a):
        return 1  # cudaErrorInvalidValue

    with mock.patch.object(cuda_cull, "_ray_lib",
                           lambda: mock.Mock(pair_tables=refused)), \
            mock.patch.object(cuda_cull, "pair_tables_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="pair_tables"):
            cuda_cull.pair_tables(acc, o, d, 1e-3, tm, 6, 8, 4)


def test_pair_occupancy(cuda):
    occ = cuda_cull.pair_occupancy(2561)
    for name in ("pair_cull", "pair_scan", "pair_rank"):
        assert occ[name]["registers"] > 0 and occ[name]["warps_per_sm"] >= 1


# --- ctiles' 2-level cull: block_cull at levels 2 ----------------------------

CTILES2_CARD = [(name, b) for name in cases.CTILES2_CASES
                for b in cases.CTILES2_BLOCKS]


def _ctiles2_args(case, dev):
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    acc = SimpleNamespace(**{k: t(case[k]) for k in WL_BOX_KEYS},
                          num_clusters=case["bmin"].shape[0],
                          num_supers=case["sbmin"].shape[0],
                          super_size=case["ss"])
    return acc, t(case["o_blk"]), t(case["d_blk"]), t(case["tm_blk"])


@pytest.mark.parametrize("name,b", CTILES2_CARD)
def test_block_cull_2level_matches_plain(cuda, name, b):
    """block_cull at levels 2 on the crafted cases, at the case's cap and
    super_cap, one past each and kslots' kc / ks, with no live-block count,
    a count inside the wave (its tail dead, and live) and 0, against the
    plain version run on the CPU: order, n_cand and over exact."""
    case = cases.ctiles2_case(name, b)
    acc, *blk = _ctiles2_args(case, cuda)
    acc_c, *blk_c = _ctiles2_args(case, "cpu")
    nb = blk[0].shape[0]
    cap, scap = case["cap"], case["super_cap"]
    runs = [(c_, s_, None, False) for c_, s_ in (
        (cap, scap), (cap + 1, scap), (cap, scap + 1),
        (case["kc"], case["ks"]))]
    runs += [(cap, scap, lb, tail) for lb in (nb // 2 + 1, 0, nb)
             for tail in (False, True)]
    for c_, s_, lb, live_tail in runs:
        tm, tm_c = blk[2].clone(), blk_c[2].clone()
        if lb is not None and not live_tail:
            tm[lb:] = -1.0
            tm_c[lb:] = -1.0
        bound = (None if lb is None else
                 torch.tensor([lb], dtype=torch.int32, device=cuda))
        before = cuda_ctiles.cull2_launches
        got = cuda_ctiles.block_cull(acc, blk[0], blk[1], tm, case["t_min"],
                                     c_, bound, levels=2, super_cap=s_)
        assert cuda_ctiles.cull2_launches == before + 1
        want = cuda_ctiles.block_cull_plain(acc_c, blk_c[0], blk_c[1], tm_c,
                                            case["t_min"], c_, lb, levels=2,
                                            super_cap=s_)
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), (
            c_, s_, lb, live_tail)


@pytest.mark.parametrize("cap,super_cap", [(48, 48), (16, 4), (200, 64)])
@pytest.mark.parametrize("b", [8, 4])
@pytest.mark.parametrize("on_faces", [False, True])
def test_block_cull_2level_on_a_bounce_wave(cuda, rng, b, cap, super_cap,
                                           on_faces):
    """Sorted bounce-wave blocks on the blob accel in clusters of 16 (321
    clusters in 21 supers of 16, the last partly filled) with the dead
    rays last, at the routes' caps and caps that overflow: the kernel
    against the plain version run on the card, with the device live-block
    count and without it."""
    acc = _accel(cuda, s=16)
    n = 1 << 13
    blocks = _cull_blocks(acc, rng, n, b, n - 1000, on_faces)
    lb = -(-(n - 1000) // b)
    for live in (None, lb):
        bound = (None if live is None else
                 torch.tensor([live], dtype=torch.int32, device=cuda))
        got = cuda_ctiles.block_cull(acc, *blocks, 1e-3, cap, bound,
                                     levels=2, super_cap=super_cap)
        want = cuda_ctiles.block_cull_plain(acc, *blocks, 1e-3, cap, live,
                                            levels=2, super_cap=super_cap)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if super_cap == 48:
        assert got[1].float().mean() > 1


@pytest.mark.parametrize("query", ["closest", "any"])
def test_ctiles_2level_reads_no_host_value(cuda, rng, query):
    """closest_hit_ctiles / any_hit_ctiles at levels=2: one launch of the
    2-level cull, no host read from accel.ctiles, and the bits of the same
    calls with the plain cull patched in."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import ctiles
    from path_tracer_ai_tpu_torch.utils import sync

    acc = _accel(cuda, s=16)
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    fn = (ctiles.closest_hit_ctiles if query == "closest"
          else ctiles.any_hit_ctiles)
    torch.cuda.synchronize()
    sync.reset()
    before = cuda_ctiles.cull2_launches
    got = fn(acc, o, d, 1e-3, tm, levels=2)
    torch.cuda.synchronize()
    assert cuda_ctiles.cull2_launches == before + 1
    assert not [k for k in sync.sites if ".accel.ctiles:" in k]
    with mock.patch.object(cuda_ctiles, "block_cull",
                           cuda_ctiles.block_cull_plain):
        want = fn(acc, o, d, 1e-3, tm, levels=2)
    if query == "closest":
        assert torch.equal(_bits(got.t), _bits(want.t))
        assert torch.equal(got.tri, want.tri) and got.hit.any()
    else:
        assert torch.equal(got, want) and 0 < got.float().mean() < 1


def test_block_cull_2level_raises(cuda):
    """Bad tables raise before a launch, a refused launch raises, and
    nothing falls back to the plain version."""
    from unittest import mock

    case = cases.ctiles2_case("count_edges", 8)
    acc, *blk = _ctiles2_args(case, cuda)
    bad = type(acc)(**{**vars(acc), "cbmin": acc.cbmin.double()})
    with pytest.raises(TypeError, match="cbmin"):
        cuda_ctiles.block_cull(bad, *blk, 1e-3, 6, None, levels=2,
                               super_cap=2)
    bad = type(acc)(**{**vars(acc),
                       "cbmax": acc.cbmax[:, :2].contiguous()})
    with pytest.raises(ValueError, match="children"):
        cuda_ctiles.block_cull(bad, *blk, 1e-3, 6, None, levels=2,
                               super_cap=2)
    lib = mock.Mock(block_cull_2level=mock.Mock(return_value=1))
    with mock.patch.object(cuda_ctiles.cuda_build, "load", lambda name: lib), \
            mock.patch.object(cuda_ctiles, "block_cull_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="block_cull"):
            cuda_ctiles.block_cull(acc, *blk, 1e-3, 6, None, levels=2,
                                   super_cap=2)


def test_block_cull_2level_occupancy(cuda):
    occ = cuda_ctiles.cull_occupancy(8, levels=2, super_cap=48)
    assert occ["registers"] > 0 and occ["warps_per_sm"] >= 8


# --- the exact shadow cull: exact_cull; perray's entry order: perray_entry --

def _exact_accel(case, dev):
    from types import SimpleNamespace

    t = lambda a: torch.as_tensor(a, device=dev)
    return SimpleNamespace(**{k: t(case[k]) for k in WL_BOX_KEYS},
                           num_clusters=case["bmin"].shape[0],
                           num_supers=case["sbmin"].shape[0],
                           super_size=case["ss"])


def _exact_same(got, want, bits=True) -> bool:
    """order, n_cand identical; entry_sorted bit for bit (bits) or as
    values (-0.0 == +0.0: against the CPU, whose entries come from the
    plain conservative cull)."""
    ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got[:2], want[:2]))
    if bits:
        return ok and torch.equal(_bits(got[2].cpu()), _bits(want[2].cpu()))
    return ok and bool((got[2].cpu() == want[2].cpu()).all())


def _exact_kernel(acc, blk, t_min, ksup):
    """exact_cull once: one packet_cull and one exact_cull launch."""
    before = (cuda_cull.launches, cuda_cull.exact_launches)
    got = cuda_cull.exact_cull(acc, *blk, t_min, ksup)
    assert (cuda_cull.launches, cuda_cull.exact_launches) == (
        before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("ksup_add", [0, 1])
@pytest.mark.parametrize("name", cases.EXACT_CASES)
def test_exact_cull_matches_plain(cuda, name, ksup_add):
    """exact_cull on the crafted exact cases (the inf-entry id past n_cand
    among them) at the case's ksup and one past it: bit for bit the plain
    version on the card, with and without the live-block count, and the
    plain version on the CPU."""
    case = cases.exact_case(name)
    ksup = case["ksup"] + ksup_add
    t = lambda a, dev: torch.as_tensor(a, device=dev)
    blk = [t(case[k], cuda) for k in ("o_blk", "d_blk", "tm_blk")]
    acc = _exact_accel(case, cuda)
    got = _exact_kernel(acc, blk, case["t_min"], ksup)
    want = cuda_cull.exact_cull_plain(acc, *blk, case["t_min"], ksup)
    live = np.nonzero((case["tm_blk"] >= 0).any(axis=1))[0]
    want_live = cuda_cull.exact_cull_plain(acc, *blk, case["t_min"], ksup,
                                           int(live[-1]) + 1)
    cpu = cuda_cull.exact_cull_plain(
        _exact_accel(case, "cpu"),
        *(t(case[k], "cpu") for k in ("o_blk", "d_blk", "tm_blk")),
        case["t_min"], ksup)
    torch.cuda.synchronize()
    assert _exact_same(got, want) and _exact_same(got, want_live)
    assert _exact_same(got, cpu, bits=False)


@pytest.mark.parametrize("b,ksup", [(64, 6), (64, 16), (128, 16), (256, 6),
                                    (1, 6), (300, 6)])
def test_exact_cull_on_a_shadow_wave(cuda, rng, b, ksup):
    """A bounce wave of the blob accel (subdiv 4 in clusters of 16: C 321 in
    21 supers of 16, so that ksup 6 and 16 leave blocks past the shortlist)
    in sorted blocks of b: the kernel against the plain version on the
    card (with the live-block count), whole tables."""
    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda, s=16)
    n = (1 << 14) // b * b
    o, d, tm = _bounce_wave(acc, n, rng)
    o, d, tm, _perm = traverse._sort_rays(acc, o, d, tm, "dir")
    blk = (o.reshape(-1, b, 3).contiguous(), d.reshape(-1, b, 3).contiguous(),
           tm.reshape(-1, b).contiguous())
    got = _exact_kernel(acc, blk, 1e-3, ksup)
    want = cuda_cull.exact_cull_plain(acc, *blk, 1e-3, ksup,
                                      traverse.live_block_count(blk[2]))
    torch.cuda.synchronize()
    assert _exact_same(got, want) and int(got[1].sum()) > 0


def test_exact_cull_on_the_worklist_accel(cuda, rng):
    """The worklist cell's accel (blob subdiv 7, S 128: C 2,561 in 161
    supers of 16) at ksup 6, blocks of 64: kernel against plain."""
    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda, subdiv=7)
    assert acc.num_clusters > 2048
    o, d, tm = _bounce_wave(acc, 1 << 14, rng)
    o, d, tm, _perm = traverse._sort_rays(acc, o, d, tm, "dir")
    blk = (o.reshape(-1, 64, 3).contiguous(),
           d.reshape(-1, 64, 3).contiguous(), tm.reshape(-1, 64).contiguous())
    for ksup in (6, 16):
        got = _exact_kernel(acc, blk, 1e-3, ksup)
        want = cuda_cull.exact_cull_plain(acc, *blk, 1e-3, ksup)
        torch.cuda.synchronize()
        assert _exact_same(got, want)


@pytest.mark.parametrize("route", ["packets", "packets_unsorted",
                                   "fused_any", "fused_closest"])
def test_exact_routes_launch_the_kernel(cuda, rng, route):
    """Each exact route on the card (the blob accel in clusters of 16, C
    321): one packet_cull and one exact_cull launch a call, no live-block
    count, no plain version; the result is that of the same route with the
    plain version on the card (occlusion exact, closest t bit for bit)."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda, s=16)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)

    def run(a, o_, d_, tm_):
        if route.startswith("packets"):
            return traverse.any_hit_packets(
                a, o_, d_, 1e-3, tm_, block_size=64, exact_cull=6,
                sort=route == "packets")
        if route == "fused_any":
            return cuda_anyhit.any_hit_fused(a, o_, d_, 1e-3, tm_,
                                             exact_cull=16)
        return cuda_closest.closest_hit_fused(a, o_, d_, 1e-3, tm_,
                                              exact_cull=16).t

    def refused(*a, **k):
        raise AssertionError("read on the card")

    before = (cuda_cull.launches, cuda_cull.exact_launches)
    with mock.patch.object(traverse, "live_block_count", refused), \
            mock.patch.object(cuda_cull, "exact_cull_plain", refused):
        got = run(acc, o, d, tm)
    torch.cuda.synchronize()
    assert (cuda_cull.launches, cuda_cull.exact_launches) == (
        before[0] + 1, before[1] + 1)
    with mock.patch.object(cuda_cull, "exact_cull",
                           lambda *a: cuda_cull.exact_cull_plain(*a)):
        want = run(acc, o, d, tm)
    if got.dtype == torch.float32:
        assert torch.equal(_bits(got), _bits(want))
    else:
        assert torch.equal(got, want)


def test_exact_cull_launch_failure_raises(cuda):
    """A refused launch raises; nothing falls back to the plain version;
    a shape past the shared memory raises before any launch."""
    from unittest import mock

    case = cases.exact_case("super_edge")
    acc = _exact_accel(case, cuda)
    blk = [torch.as_tensor(case[k], device=cuda)
           for k in ("o_blk", "d_blk", "tm_blk")]
    lib = cuda_cull._lib()
    refused = mock.Mock(return_value=1)  # cudaErrorInvalidValue
    fake = mock.Mock(packet_cull=lib.packet_cull,
                     packet_cull_scratch_bytes=lib.packet_cull_scratch_bytes,
                     exact_cull_smem_bytes=lib.exact_cull_smem_bytes,
                     exact_cull=refused)
    with mock.patch.object(cuda_cull, "_lib", lambda: fake), \
            mock.patch.object(cuda_cull, "exact_cull_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="exact_cull"):
            cuda_cull.exact_cull(acc, *blk, 1e-3, 3)
    assert refused.called
    big = type(acc)(**{**vars(acc), "num_supers": 1,
                       "super_size": 1 << 16})
    big.sbmin, big.sbmax = acc.sbmin[:1], acc.sbmax[:1]
    big.cbmin = torch.zeros((1, 1 << 16, 3), device=cuda)
    big.cbmax = torch.zeros((1, 1 << 16, 3), device=cuda)
    before = cuda_cull.launches
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cull.exact_cull(big, *blk, 1e-3, 1)
    assert cuda_cull.launches == before


def test_exact_cull_occupancy(cuda):
    for r, ksup in ((64, 6), (128, 16), (256, 6)):
        occ = cuda_cull.exact_occupancy(r, 41, ksup, 16)
        assert occ["registers"] > 0 and occ["warps_per_sm"] >= 8


@pytest.mark.parametrize("name", cases.RAY_CULL_CASES)
def test_perray_entry_matches_plain(cuda, name):
    """perray_entry on the per-ray cull cases at three caps (the case's,
    one past it, 1): bit for bit the plain version on the CPU, one launch
    a call."""
    case = cases.ray_cull_case(name)
    accs = [_exact_accel(case, dev) for dev in (cuda, "cpu")]
    rays = [[torch.as_tensor(case[k], device=dev) for k in ("o", "d", "tm")]
            for dev in (cuda, "cpu")]
    for cap in cases.perray_entry_caps(case):
        before = cuda_cull.entry_launches
        (o, d, tm), (oc, dc, tc) = rays
        got = cuda_cull.perray_entry(accs[0], o, d, case["t_min"], tm, cap)
        assert cuda_cull.entry_launches == before + 1
        want = cuda_cull.perray_entry_plain(accs[1], oc, dc, case["t_min"],
                                            tc, cap)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(_bits(got[2].cpu()), _bits(want[2]))
        assert torch.equal(got[3].cpu(), want[3])


@pytest.mark.parametrize("s,cap", [(128, 16), (128, 64), (16, 48)])
def test_perray_entry_on_a_bounce_wave(cuda, rng, s, cap):
    """A bounce wave through _perray_candidates(order_mode="entry") on the
    card: one perray_entry launch, the plain version's lists on the card
    bit for bit."""
    from unittest import mock

    from path_tracer_ai_tpu_torch.accel import traverse

    acc = _accel(cuda, s=s)
    o, d, tm = _bounce_wave(acc, 1 << 13, rng)
    before = cuda_cull.entry_launches
    with mock.patch.object(cuda_cull, "perray_entry_plain",
                           mock.Mock(side_effect=AssertionError)):
        got = traverse._perray_candidates(acc, o, d, 1e-3, tm, cap,
                                          order_mode="entry")
    assert cuda_cull.entry_launches == before + 1
    want = cuda_cull.perray_entry_plain(acc, o, d, 1e-3, tm, cap)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[2]), _bits(want[2]))
    assert torch.equal(got[3], want[3]) and int(got[1].sum()) > 0


def test_perray_entry_launch_failure_raises_and_occupancy(cuda):
    from unittest import mock

    case = cases.ray_cull_case("count_edges")
    acc = _exact_accel(case, cuda)
    o, d, tm = (torch.as_tensor(case[k], device=cuda) for k in ("o", "d",
                                                                "tm"))
    lib = mock.Mock(perray_entry=mock.Mock(return_value=1))
    with mock.patch.object(cuda_cull, "_ray_lib", lambda: lib), \
            mock.patch.object(cuda_cull, "perray_entry_plain",
                              mock.Mock(side_effect=AssertionError)):
        with pytest.raises(RuntimeError, match="perray_entry"):
            cuda_cull.perray_entry(acc, o, d, 1e-3, tm, 6)
    occ = cuda_cull.ray_occupancy()["perray_entry"]
    assert occ["registers"] > 0 and occ["warps_per_sm"] >= 8
