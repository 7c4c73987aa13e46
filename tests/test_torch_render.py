"""Same-seed renders of the port against the JAX package, and the port's
own invariants, on a small benchmark-like scene.

Scene, accels and camera are carried across from the JAX package with
convert.py, so both sides see identical bits. Tolerance against JAX:
RMSE <= 1e-3 x the image mean. The random draws are bit-equal, and every
square root and the default camera's tangent correctly rounded, on both
sides (test_torch_numerics); but inside its jitted functions XLA's CPU
code contracts FMAs and divides by a constant as a multiply by its
reciprocal, and eager torch does neither (the camera rays already differ
in the last ulps), so a few paths take another bounce: measured 2.49e-5 x
the mean.
Within the port, the wavefront engine equals the oracle bitwise on the
CPU, across wave sizes and with compaction forced.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu.config import RenderSettings as JSettings
from path_tracer_ai_tpu.engine import oracle as joracle
from path_tracer_ai_tpu.engine import wavefront as jwavefront
from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.convert import (
    accel_from_numpy,
    camera_from_numpy,
    scene_from_numpy,
)
from path_tracer_ai_tpu_torch.engine import oracle, wavefront

RMSE_REL = 1e-3
W, H, SPP, BOUNCES, SEED = 32, 18, 2, 3, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, whose torch threads would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return [np.asarray(a) for a in tree]


@pytest.fixture(scope="module")
def both():
    from __graft_entry__ import _demo_scene

    jscene, jaccel = _demo_scene(subdivisions=2)
    t = jscene.triangles
    jaccel_c = jbuild(SimpleNamespace(v0=np.asarray(t.v0), v1=np.asarray(t.v1),
                                      v2=np.asarray(t.v2)), cluster_size=256)
    scene = scene_from_numpy(_np(jscene.triangles), _np(jscene.materials),
                             _np(jscene.lights), device="cpu")
    return dict(
        jscene=jscene, jaccel=jaccel, jaccel_c=jaccel_c, scene=scene,
        accel=accel_from_numpy(*_np(jaccel), device="cpu"),
        accel_c=accel_from_numpy(*_np(jaccel_c), device="cpu"),
        camera=camera_from_numpy(*_np(jcamera()), device="cpu"),
    )


def _settings(cls):
    return cls(width=W, height=H, samples_per_pixel=SPP, max_bounces=BOUNCES,
               seed=SEED)


def _port_wave(b, wave_size=1 << 11):
    return wavefront.render(b["scene"], b["camera"], _settings(RenderSettings),
                            accel=b["accel"], accel_closest=b["accel_c"],
                            wave_size=wave_size, device="cpu")


@pytest.fixture(scope="module")
def port_images(both):
    return dict(wave=_port_wave(both),
                oracle=oracle.render(both["scene"], both["camera"],
                                     _settings(RenderSettings), device="cpu"))


def _assert_close(img, ref):
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse <= RMSE_REL * float(ref.mean()), (rmse, float(ref.mean()))


def test_wavefront_matches_jax_wavefront(both, port_images):
    ref = np.asarray(jwavefront.render(
        both["jscene"], jcamera(), _settings(JSettings), accel=both["jaccel"],
        accel_closest=both["jaccel_c"], wave_size=1 << 11, block_size=64))
    assert (ref.max(-1) > 0).mean() > 0.5
    _assert_close(port_images["wave"], ref)


def test_oracle_matches_jax_oracle(both, port_images):
    ref = np.asarray(joracle.render(both["jscene"], jcamera(),
                                    _settings(JSettings)))
    _assert_close(port_images["oracle"], ref)


def test_wavefront_equals_oracle_bitwise(port_images):
    np.testing.assert_array_equal(port_images["wave"], port_images["oracle"])


@pytest.mark.parametrize("wave_size", [1 << 9, 1 << 10, 1 << 13])
def test_bit_identity_across_wave_sizes(both, port_images, wave_size):
    np.testing.assert_array_equal(_port_wave(both, wave_size),
                                  port_images["wave"])


def test_bit_identity_with_compaction_forced(both, port_images, monkeypatch):
    monkeypatch.setattr(wavefront, "COMPACT_MIN_BUCKET", 64)
    stats = wavefront.RenderStats()
    img = wavefront.render(both["scene"], both["camera"],
                           _settings(RenderSettings), accel=both["accel"],
                           accel_closest=both["accel_c"], wave_size=1 << 11,
                           stats=stats, device="cpu")
    np.testing.assert_array_equal(img, port_images["wave"])
    assert 0 < stats.closest_rays < W * H * SPP * BOUNCES
    assert stats.shadow_rays > 0


def test_render_stats_match_jax(both):
    js, ps = jwavefront.RenderStats(), wavefront.RenderStats()
    jwavefront.render(both["jscene"], jcamera(), _settings(JSettings),
                      accel=both["jaccel"], accel_closest=both["jaccel_c"],
                      wave_size=1 << 11, block_size=64, stats=js)
    wavefront.render(both["scene"], both["camera"], _settings(RenderSettings),
                     accel=both["accel"], accel_closest=both["accel_c"],
                     wave_size=1 << 11, stats=ps, device="cpu")
    # live ray counts depend on hits; a diverged path may move them slightly
    assert abs(ps.closest_rays - js.closest_rays) <= 0.01 * js.closest_rays
    assert abs(ps.shadow_rays - js.shadow_rays) <= 0.01 * js.shadow_rays


def test_port_builds_its_own_accels(both, port_images):
    """Without accels passed in, render builds both (S=128 and S=256)."""
    img = wavefront.render(both["scene"], both["camera"],
                           _settings(RenderSettings), wave_size=1 << 11,
                           device="cpu")
    np.testing.assert_array_equal(img, port_images["wave"])


# --- the two further paths: backend="pallas" and the fused cascades ---------

FUSED_OCCLUDE_KW = dict(engine="packets_fused", early_skip=True, sub_skip=True)
FUSED_CLOSEST_KW = dict(engine="cascade_fused")


def _port_render(b, **kw):
    return wavefront.render(b["scene"], b["camera"], _settings(RenderSettings),
                            accel=b["accel"], wave_size=1 << 11, device="cpu",
                            **kw)


@pytest.fixture
def fused_engines(monkeypatch):
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", FUSED_OCCLUDE_KW)
    monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW", FUSED_CLOSEST_KW)


def test_fused_render_equals_oracle_bitwise(both, port_images, fused_engines):
    """Both fused cascades keep the oracle's (t, min tri) rule, so the
    image is the oracle's bit for bit; no second accel is built or used."""
    stats = wavefront.RenderStats()
    img = _port_render(both, stats=stats)
    np.testing.assert_array_equal(img, port_images["oracle"])
    assert stats.closest_rays > 0 and stats.shadow_rays > 0


@pytest.mark.parametrize("kw", [dict(backend="pallas"),
                                dict(use_pallas=True, block_size=128)])
def test_pallas_render_close_to_hybrid(both, port_images, kw):
    """The pallas backend keeps the first candidate on an exact tie where
    the other backends keep the smallest triangle id, so it is held at
    atol 1e-5 (as tests/test_pallas.py holds the JAX pair), not bitwise."""
    img = _port_render(both, **kw)
    np.testing.assert_allclose(img, port_images["wave"], atol=1e-5)


def test_pallas_render_matches_jax_pallas(both, monkeypatch):
    """Against the JAX package's pallas backend, its kernels in interpret
    mode (16x9: interpret mode is slow)."""
    import functools

    small = dict(width=16, height=9, samples_per_pixel=SPP,
                 max_bounces=BOUNCES, seed=SEED)
    monkeypatch.setattr(jwavefront, "packet_backend", functools.partial(
        jwavefront.packet_backend, interpret=True))
    jwavefront.clear_executable_caches()
    try:
        ref = np.asarray(jwavefront.render(
            both["jscene"], jcamera(), JSettings(**small),
            accel=both["jaccel"], wave_size=1 << 11, block_size=64,
            use_pallas=True))
    finally:
        monkeypatch.undo()
        jwavefront.clear_executable_caches()
    img = wavefront.render(both["scene"], both["camera"],
                           RenderSettings(**small), accel=both["accel"],
                           wave_size=1 << 11, backend="pallas", device="cpu")
    assert (ref.max(-1) > 0).mean() > 0.5
    _assert_close(img, ref)


def test_fused_render_matches_jax_fused(both, monkeypatch):
    """Against the JAX package's fused cascades, their kernels in interpret
    mode (16x9: interpret mode is slow)."""
    small = dict(width=16, height=9, samples_per_pixel=SPP,
                 max_bounces=BOUNCES, seed=SEED)
    monkeypatch.setattr(jwavefront, "HYBRID_OCCLUDE_KW",
                        dict(FUSED_OCCLUDE_KW, interpret=True))
    monkeypatch.setattr(jwavefront, "HYBRID_CLOSEST_KW",
                        dict(FUSED_CLOSEST_KW, interpret=True))
    jwavefront.clear_executable_caches()
    try:
        ref = np.asarray(jwavefront.render(
            both["jscene"], jcamera(), JSettings(**small),
            accel=both["jaccel"], wave_size=1 << 11, block_size=64,
            backend="hybrid"))
    finally:
        monkeypatch.undo()
        jwavefront.clear_executable_caches()
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", FUSED_OCCLUDE_KW)
    monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW", FUSED_CLOSEST_KW)
    img = wavefront.render(both["scene"], both["camera"],
                           RenderSettings(**small), accel=both["accel"],
                           wave_size=1 << 11, device="cpu")
    assert (ref.max(-1) > 0).mean() > 0.5
    _assert_close(img, ref)


@pytest.mark.parametrize("backend", ["no_such_backend"])
def test_unported_backends_raise(both, backend):
    with pytest.raises(ValueError, match=backend):
        _port_render(both, backend=backend)


@pytest.mark.parametrize("backend", ["packets", "worklist", "pairs",
                                     "ctiles", "kslots"])
def test_ported_backends_render_equal_oracle(both, port_images, backend):
    """The worklist, pairs, packets, ctiles and kslots backends (once
    raising here, as unported) on the base accel: the image equals the
    oracle's bit for bit. ctiles' shadow waves are lane-major, in blocks of
    a lane's 4 rays; kslots resolves by the oracle's (t, min tri) rule."""
    stats = wavefront.RenderStats()
    img = _port_render(both, backend=backend, block_size=64, stats=stats)
    np.testing.assert_array_equal(img, port_images["oracle"])
    assert stats.closest_rays > 0 and stats.shadow_rays > 0


def test_hybrid_worklist_shadow_engine_renders(both, port_images,
                                               monkeypatch):
    """The hybrid backend's shadow engine "worklist" (any_hit_worklist with
    HYBRID_OCCLUDE_KW's options; once raising as unported): occlusion is
    exact, so the image is the oracle's."""
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW",
                        dict(engine="worklist", sort=False))
    img = _port_render(both, accel_closest=both["accel_c"])
    np.testing.assert_array_equal(img, port_images["oracle"])


@pytest.mark.parametrize("lane_major", [False, True])
def test_hybrid_ctiles_shadow_engine_renders(both, port_images, monkeypatch,
                                            lane_major):
    """The hybrid backend's shadow engine "ctiles" (any_hit_ctiles with
    HYBRID_OCCLUDE_KW's options; once raising as unported), light-major or
    lane-major: occlusion is exact, so the image is the oracle's."""
    kw = dict(engine="ctiles")
    if lane_major:
        kw.update(lane_major=True, block=4, sort=False)
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", kw)
    img = _port_render(both, accel_closest=both["accel_c"])
    np.testing.assert_array_equal(img, port_images["oracle"])


@pytest.mark.parametrize("kw", [dict(backend="perray"), dict(block_size=1)])
def test_perray_render_close_to_oracle(both, port_images, kw):
    """The perray backend (by name, and block_size=1, the reference's
    legacy spelling): its tie rule is the packet cascade's (the first slot
    at the minimum t of a group), so it is held at atol 1e-5 against the
    oracle, with the differing pixels counted."""
    img = _port_render(both, **kw)
    diff = np.abs(img - port_images["oracle"]).max(axis=-1)
    assert (diff > 0).sum() <= 0.01 * diff.size
    np.testing.assert_allclose(img, port_images["oracle"], atol=1e-5)


@pytest.mark.parametrize("backend", ["ctiles", "perray"])
@pytest.mark.parametrize("kw", [dict(scheduler="pool"),
                                dict(tile_devices=2)])
def test_ctiles_and_perray_through_pool_and_mesh(both, port_images, backend,
                                                 kw):
    """The pool scheduler and the mesh pass the backend through: ctiles
    gives the oracle's image bit for bit, perray within atol 1e-5."""
    img = _port_render(both, backend=backend, **kw)
    if backend == "ctiles":
        np.testing.assert_array_equal(img, port_images["oracle"])
    else:
        np.testing.assert_allclose(img, port_images["oracle"], atol=1e-5)


def test_worklist_packets_exact_shadows_equal_oracle(both, port_images,
                                                     monkeypatch):
    """WORKLIST_OCCLUDE_ENGINE = "packets_exact" (once raising as unported):
    the worklist backend's shadow waves through the exact-cull packet
    cascade; occlusion is exact, so the image is the oracle's."""
    monkeypatch.setattr(wavefront, "WORKLIST_OCCLUDE_ENGINE", "packets_exact")
    img = _port_render(both, backend="worklist")
    np.testing.assert_array_equal(img, port_images["oracle"])


@pytest.mark.parametrize("closest_kw,occlude_kw,match", [
    (dict(engine="pairs"), dict(engine="packets"), "pairs"),
    (dict(engine="ctiles"), dict(engine="kslots"), "kslots"),
])
def test_unported_engines_and_exact_cull_raise(both, monkeypatch, closest_kw,
                                               occlude_kw, match):
    monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW", closest_kw)
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", occlude_kw)
    with pytest.raises(ValueError, match=match):
        _port_render(both)


@pytest.mark.parametrize("closest_kw,occlude_kw", [
    (dict(engine="ctiles"), dict(engine="packets", group_size=2)),
    (dict(engine="ctiles"), dict(engine="packets_fused")),
    (dict(engine="cascade_fused"), dict(engine="packets", group_size=2)),
])
def test_exact_cull_engines_render_equal_conservative(both, port_images,
                                                      monkeypatch, closest_kw,
                                                      occlude_kw):
    """exact_cull (once raising as unported) in the hybrid packet cascade
    (6), the fused any-hit cascade (16) and the fused closest cascade (16):
    the image equals the same engines' with the conservative cull, and the
    oracle's."""
    ex_closest = dict(closest_kw)
    ex_occlude = dict(occlude_kw)
    if closest_kw["engine"] == "cascade_fused":
        ex_closest["exact_cull"] = 16
    else:
        ex_occlude["exact_cull"] = 6 if occlude_kw["engine"] == "packets" \
            else 16
    imgs = []
    for ckw, okw in ((closest_kw, occlude_kw), (ex_closest, ex_occlude)):
        monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW", ckw)
        monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", okw)
        imgs.append(_port_render(both, accel_closest=both["accel_c"]))
    np.testing.assert_array_equal(imgs[1], imgs[0])
    np.testing.assert_array_equal(imgs[1], port_images["oracle"])


def test_block_size_one_means_perray(both, monkeypatch):
    """The reference's legacy spelling of backend="perray": block_size=1
    renders through the perray queries."""
    from path_tracer_ai_tpu_torch.accel import traverse

    calls = []
    real = traverse.any_hit_perray
    monkeypatch.setattr(traverse, "any_hit_perray",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert wavefront.resolve_backend(both["accel"], 1, False, None) == "perray"
    img = _port_render(both, block_size=1)
    assert calls and np.isfinite(img).all()


def test_default_render_past_2048_clusters():
    """Such scenes go to the worklist backend, as in the reference (its
    2-level cull: 2,564 clusters in 161 supers), and the image equals the
    oracle's bitwise."""
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(4, device="cpu")
    accel = build_clusters(scene.triangles, cluster_size=2, device="cpu")
    assert accel.num_clusters > 2048
    assert wavefront.resolve_backend(accel, 64, False, None) == "worklist"
    settings = RenderSettings(width=16, height=9, samples_per_pixel=1,
                              max_bounces=2, seed=1)
    img = wavefront.render(scene, default_camera(device="cpu"), settings, accel=accel,
                           wave_size=1 << 8, device="cpu")
    np.testing.assert_array_equal(
        img, oracle.render(scene, default_camera(device="cpu"), settings, device="cpu"))


@pytest.mark.parametrize("engines,kw,builders", [
    (None, {}, ["pack_tris", "pack_tris"]),  # base accel and closest accel
    # (the 16-row pack holds the 10-row one)
    ("fused", {}, ["pack_tris_dummy", "pack_tris"]),
    (None, dict(backend="pallas"), ["build_slab_table"]),
])
def test_render_builds_each_pack_once(both, monkeypatch, engines, kw, builders):
    """render makes two backends (bounce 0 unsorted, the rest sorted) from
    one set of triangle packs."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_ctiles,
        cuda_sweep,
    )

    if engines:
        monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW", FUSED_OCCLUDE_KW)
        monkeypatch.setattr(wavefront, "HYBRID_CLOSEST_KW", FUSED_CLOSEST_KW)
    built = []
    for mod, name in ((cuda_ctiles, "pack_tris"),
                      (cuda_anyhit, "pack_tris_dummy"),
                      (cuda_sweep, "build_slab_table")):
        def counted(accel, _fn=getattr(mod, name), _name=name):
            built.append(_name)
            return _fn(accel)
        counted.__name__ = name
        monkeypatch.setattr(mod, name, counted)
    if not engines and not kw:
        kw = dict(accel_closest=both["accel_c"])
    _port_render(both, **kw)
    assert built == builders
