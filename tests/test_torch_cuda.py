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
    before = cuda_ctiles.launches
    img = wavefront.render(scene, cam, s, wave_size=1 << 11, device=cuda,
                           **kw)
    ref = oracle.render(scene, cam, s, device=cuda)
    if route == "perray":
        np.testing.assert_allclose(img, ref, atol=1e-5)
        return
    assert cuda_ctiles.launches > before
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
    before = cuda_ctiles.launches
    img_w = wavefront.render(scene, default_camera(cuda), s, wave_size=1 << 11,
                             device=cuda)
    assert cuda_ctiles.launches > before
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
    pairs (pair tiles, tile_sweep) and packets (both packet cascades, the
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
    before = (cuda_items.launches, cuda_ctiles.launches,
              dict(cuda_cascade.launches))
    img = wavefront.render(scene, cam, s, accel=acc, wave_size=1 << 11,
                           device=cuda, **kw)
    if backend == "worklist":
        assert cuda_items.launches > before[0]
    elif backend == "pairs":
        assert cuda_ctiles.launches > before[1]
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
    equals the oracle's bitwise, and tile_sweep was launched."""
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
    before = cuda_ctiles.launches
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
    assert cuda_ctiles.launches > before
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
    tab = kslots._chunk_tables(acc, o, d, tm, 1e-3, 6, k_clusters,
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
    cascade stage kernel's first-slot fold, and perray (kslot_sweep
    first-slot and any-hit). Each launches its kernel and never the eager
    sweeps; packets and worklist equal the oracle's image bitwise, perray
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
    before = (cuda_ctiles.slot_launches, cuda_kslots.slot_launches,
              cuda_kslots.launches,
              cuda_cascade.launches["cascade_stage_first"])
    img = wavefront.render(scene, cam, s, **kw)
    ref = oracle.render(scene, cam, s, device=cuda)
    assert not eager
    if route == "perray":
        assert cuda_kslots.slot_launches > before[1]
        assert (cuda_kslots.launches - before[2]
                > cuda_kslots.slot_launches - before[1])  # any hit too
        np.testing.assert_allclose(img, ref, atol=1e-5)
        return
    assert cuda_cascade.launches["cascade_stage_first"] > before[3]
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
    iteration), and the query reads no value back to the host (but the
    exact cull's live block count)."""
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
    assert sync.count - reads == (query == "any_exact")
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


@pytest.mark.parametrize("query", ["any", "any_skips", "any_exact",
                                   "closest", "closest_unsorted",
                                   "closest_exact"])
def test_fused_cascades_read_one_host_value(cuda, rng, monkeypatch, query):
    """any_hit_fused and closest_hit_fused on a bounce wave of the blob
    accel (S 128, blocks of 128): the stage kernel's
    results are the host-stepped loop's bits (fused_stage_plain sweeping
    through block_anyhit / block_closest, one launch an iteration), and
    the cascade reads one value back to the host, the candidate ids'
    range check (and the exact cull's live block count)."""
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
    assert sync.count - reads == 1 + ("exact_cull" in kw)
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
