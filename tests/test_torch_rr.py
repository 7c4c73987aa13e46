"""Russian roulette (RenderSettings.rr_start) in the port.

Within the port the wavefront engine equals the oracle bitwise with
roulette on: the draw rides the keyed TAG_RR stream of (lane, depth), so
neither wave size nor compaction changes a sample. rr_start = 0, and any
rr_start >= max_bounces, give the image without roulette bit for bit.
Against the JAX wavefront the images are held at the RMSE_REL of
tests/test_torch_render.py (the float path differs there, so a few
roulette decisions near u = p may too).
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.config import RenderSettings as JSettings
from path_tracer_ai_tpu.engine import wavefront as jwavefront
from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
from path_tracer_ai_tpu_torch.config import (
    RENDERER_STRUCT_DEFAULTS,
    RenderSettings,
)
from path_tracer_ai_tpu_torch.engine import oracle, wavefront
from path_tracer_ai_tpu_torch.scene.camera import default_camera
from path_tracer_ai_tpu_torch.scene.scene import build_scene_from_arrays
from tests.test_torch_render import RMSE_REL, _assert_close, both  # noqa: F401

W, H, SPP, BOUNCES, SEED = 32, 18, 2, 4, 5
RR_STARTS = [1, 2]


def _settings(cls, **kw):
    return cls(width=W, height=H, samples_per_pixel=SPP, max_bounces=BOUNCES,
               seed=SEED, **kw)


def _wave(b, rr_start, wave_size=1 << 11, **kw):
    return wavefront.render(b["scene"], b["camera"],
                            _settings(RenderSettings, rr_start=rr_start),
                            accel=b["accel"], accel_closest=b["accel_c"],
                            wave_size=wave_size, device="cpu", **kw)


@pytest.fixture(scope="module")
def images(both):
    out = {}
    for rr in [0] + RR_STARTS:
        out["wave", rr] = _wave(both, rr)
        out["oracle", rr] = oracle.render(
            both["scene"], both["camera"],
            _settings(RenderSettings, rr_start=rr), device="cpu")
    return out


def test_config_matches_jax():
    from path_tracer_ai_tpu.config import RENDERER_STRUCT_DEFAULTS as jdefaults

    assert RenderSettings().rr_start == JSettings().rr_start == 0
    for f in ("width", "height", "samples_per_pixel", "max_bounces", "gamma",
              "aspect_mode", "seed", "rr_start"):
        assert getattr(RENDERER_STRUCT_DEFAULTS, f) == getattr(jdefaults, f)


@pytest.mark.parametrize("rr_start", RR_STARTS)
def test_wavefront_equals_oracle_bitwise(images, rr_start):
    np.testing.assert_array_equal(images["wave", rr_start],
                                  images["oracle", rr_start])


@pytest.mark.parametrize("rr_start", RR_STARTS)
def test_roulette_changes_the_image(images, rr_start):
    assert not np.array_equal(images["wave", rr_start], images["wave", 0])
    assert np.isfinite(images["wave", rr_start]).all()


@pytest.mark.parametrize("engine,rr_start", [
    ("wave", BOUNCES), ("wave", BOUNCES + 3), ("oracle", BOUNCES)])
def test_roulette_past_the_last_bounce_is_off(both, images, engine, rr_start):
    """A vertex of depth >= max_bounces never exists, so no lane enters the
    roulette: the image is the rr-off one bit for bit."""
    if engine == "wave":
        img = _wave(both, rr_start)
    else:
        img = oracle.render(both["scene"], both["camera"],
                            _settings(RenderSettings, rr_start=rr_start),
                            device="cpu")
    np.testing.assert_array_equal(img, images[engine, 0])


def test_rr_off_is_the_default(both, images):
    img = wavefront.render(both["scene"], both["camera"],
                           _settings(RenderSettings), accel=both["accel"],
                           accel_closest=both["accel_c"], wave_size=1 << 11,
                           device="cpu")
    np.testing.assert_array_equal(img, images["wave", 0])


@pytest.mark.parametrize("rr_start", RR_STARTS)
def test_matches_jax_wavefront(both, images, rr_start):
    ref = np.asarray(jwavefront.render(
        both["jscene"], jcamera(), _settings(JSettings, rr_start=rr_start),
        accel=both["jaccel"], accel_closest=both["jaccel_c"],
        wave_size=1 << 11, block_size=64))
    assert (ref.max(-1) > 0).mean() > 0.5
    _assert_close(images["wave", rr_start], ref)


@pytest.mark.parametrize("rr_start,wave_size", [
    (1, 1 << 9), (1, 1 << 13), (2, 1 << 10)])
def test_bit_identity_across_wave_sizes(both, images, rr_start, wave_size):
    np.testing.assert_array_equal(_wave(both, rr_start, wave_size),
                                  images["wave", rr_start])


@pytest.mark.parametrize("rr_start", RR_STARTS)
def test_bit_identity_with_compaction_forced(both, images, monkeypatch,
                                             rr_start):
    monkeypatch.setattr(wavefront, "COMPACT_MIN_BUCKET", 64)
    np.testing.assert_array_equal(_wave(both, rr_start),
                                  images["wave", rr_start])


def test_roulette_traces_fewer_live_rays(both):
    counts = {}
    for rr in (0, 1):
        stats = wavefront.RenderStats()
        _wave(both, rr, stats=stats)
        counts[rr] = (stats.closest_rays, stats.shadow_rays)
    assert counts[1][0] < counts[0][0]
    assert counts[1][1] < counts[0][1]
    # bounce 0 is never rouletted: every primary ray is still traced
    assert counts[1][0] >= W * H * SPP


@pytest.fixture(scope="module")
def room_scene():
    tris = [
        ([-8, 0, -8], [8, 0, -8], [8, 0, 8], [0, 1, 0], 1),
        ([-8, 0, -8], [8, 0, 8], [-8, 0, 8], [0, 1, 0], 1),
        ([-8, 0, -8], [-8, 4, -8], [8, 4, -8], [0, 0, 1], 1),
        ([-8, 0, -8], [8, 4, -8], [8, 0, -8], [0, 0, 1], 1),
        ([-1, 0, -1], [1, 0, -1], [0, 3, -1], [0, 0, 1], 0),
    ]
    col = lambda i: [t[i] for t in tris]
    n = col(3)
    uv = [[0, 0]] * len(tris)
    return build_scene_from_arrays(col(0), col(1), col(2), n, n, n, uv, uv, uv,
                                   col(4), device="cpu")


def test_unbiased_mean(room_scene):
    """E[radiance] is unchanged by roulette: aggressive roulette
    (rr_start=1) at high spp agrees with the rr-off mean within Monte-Carlo
    noise (tests/test_wavefront.py::TestRussianRoulette::test_unbiased_mean,
    same scene, settings and bounds)."""
    s = RenderSettings(width=8, height=8, samples_per_pixel=512,
                       max_bounces=5, seed=3)
    cam = default_camera(device="cpu")
    base = wavefront.render(room_scene, cam, s, wave_size=1 << 13,
                            block_size=64, device="cpu")
    rr = wavefront.render(room_scene, cam, s.replace(rr_start=1, seed=4),
                          wave_size=1 << 13, block_size=64, device="cpu")
    # Whole-image mean: 32768 samples; SE ~ 0.01 at sample std ~1-2.
    assert abs(float(base.mean()) - float(rr.mean())) < 0.03
    # Per-pixel agreement at MC-noise tolerance.
    assert float(np.abs(base - rr).mean()) < 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small eager renders: the suite
    runs in parallel workers, where more threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
