"""Same-seed renders of the port against the JAX package, and the port's
own invariants, on a small benchmark-like scene.

Scene, accels and camera are carried across from the JAX package with
convert.py, so both sides see identical bits. Tolerance against JAX:
RMSE <= 1e-3 x the image mean. XLA's CPU code contracts FMAs and eager
torch does not, and normal() differs in the last ulps (test_torch_rng), so
a few paths can take another bounce; measured here ~2.5e-5 x the mean.
Within the port, the wavefront engine equals the oracle bitwise on the
CPU, across wave sizes and with compaction forced.
"""

from types import SimpleNamespace

import numpy as np
import pytest

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
                             _np(jscene.lights))
    return dict(
        jscene=jscene, jaccel=jaccel, jaccel_c=jaccel_c, scene=scene,
        accel=accel_from_numpy(*_np(jaccel)),
        accel_c=accel_from_numpy(*_np(jaccel_c)),
        camera=camera_from_numpy(*_np(jcamera())),
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
