"""The pool scheduler (wavefront.render(scheduler="pool")) and the per-lane
depth of tracer.bounce_step, against the port's wave scheduler and the
JAX package's pool.

The pool refills a lane with the next camera ray as its path ends, so the
samples of a pixel reach its sum in another order than in the wave
scheduler. At spp <= 2 a pixel sums two values into zero, which gives the
same bits in either order: the pool image must equal the wave image bit
for bit. At higher spp it is held at the reference's own tolerance
(tests/test_wavefront.py: atol 1e-5), and against the JAX pool at the
RMSE_REL of tests/test_torch_render.py. Counterparts of
tests/test_wavefront.py's pool tests and of its roulette
scheduling-invariance test.
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.config import RenderSettings as JSettings
from path_tracer_ai_tpu.engine import wavefront as jwavefront
from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core import threefry
from path_tracer_ai_tpu_torch.engine import oracle, tracer, wavefront
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt_io
from tests.test_torch_render import RMSE_REL, _assert_close, both  # noqa: F401

W, H, SEED = 32, 18, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(spp=2, bounces=3, **kw):
    return RenderSettings(width=W, height=H, samples_per_pixel=spp,
                          max_bounces=bounces, seed=SEED, **kw)


def _render(b, settings, scheduler="wave", wave_size=1 << 11, **kw):
    return wavefront.render(b["scene"], b["camera"], settings,
                            accel=b["accel"], wave_size=wave_size,
                            scheduler=scheduler, device="cpu", **kw)


@pytest.mark.parametrize("spp,wave_size,rr_start", [
    (2, 1 << 11, 0),
    (1, 1 << 11, 0),
    (2, 1 << 8, 0),   # three pixel chunks, one sample a lane pass
    (2, 1 << 11, 1),  # roulette gated per lane
])
def test_pool_equals_wave_bitwise(both, spp, wave_size, rr_start):
    s = _settings(spp=spp, rr_start=rr_start)
    st_w, st_p = wavefront.RenderStats(), wavefront.RenderStats()
    img_w = _render(both, s, wave_size=wave_size, stats=st_w)
    img_p = _render(both, s, "pool", wave_size=wave_size, stats=st_p)
    np.testing.assert_array_equal(img_p, img_w)
    assert np.isfinite(img_p).all()
    assert (st_p.closest_rays, st_p.shadow_rays) == (st_w.closest_rays,
                                                     st_w.shadow_rays)
    n_chunks = -(-W * H // wave_size)
    assert len(st_p.pool_iterations) == n_chunks
    assert min(st_p.pool_iterations) >= 3


def test_pool_equals_the_oracle_bitwise(both):
    s = _settings()
    np.testing.assert_array_equal(
        _render(both, s, "pool"),
        oracle.render(both["scene"], both["camera"], s, device="cpu"))


def test_pool_scheduler_matches_wave(both):
    """tests/test_wavefront.py::test_pool_scheduler_matches_wave: 4 spp,
    the sample order differs, atol 1e-5; the live ray counts are the
    wave scheduler's (at one sample a lane pass: a wave pass of sc > 1
    samples past spp traces samples it then drops, and counts them)."""
    s = _settings(spp=4)
    st_w, st_p = wavefront.RenderStats(), wavefront.RenderStats()
    img_w = _render(both, s, wave_size=1 << 10, stats=st_w)
    img_p = _render(both, s, "pool", wave_size=1 << 10, stats=st_p)
    np.testing.assert_allclose(img_p, img_w, atol=1e-5)
    assert st_p.closest_rays > 0 and st_p.shadow_rays > 0
    assert (st_p.closest_rays, st_p.shadow_rays) == (st_w.closest_rays,
                                                     st_w.shadow_rays)


def test_pool_scheduler_chunked_pixels(both):
    """tests/test_wavefront.py::test_pool_scheduler_chunked_pixels: a pool
    smaller than the image."""
    s = _settings(spp=4)
    img_p = _render(both, s, "pool", wave_size=1 << 8)
    img_w = _render(both, s, wave_size=1 << 8)
    np.testing.assert_allclose(img_p, img_w, atol=1e-5)


def test_pool_matches_jax_pool(both):
    s = dict(width=W, height=H, samples_per_pixel=4, max_bounces=3,
             seed=SEED)
    ref = np.asarray(jwavefront.render(
        both["jscene"], jcamera(), JSettings(**s), accel=both["jaccel"],
        wave_size=1 << 11, block_size=64, scheduler="pool"))
    _assert_close(_render(both, RenderSettings(**s), "pool"), ref)


def _restamp(ck, settings_from, settings_to, count, seed=SEED):
    acc, cnt, next_s = ckpt_io.load(
        ck, ckpt_io.fingerprint(settings_from, count, seed))
    ckpt_io.save(ck, acc, cnt, next_s,
                 ckpt_io.fingerprint(settings_to, count, seed))
    return next_s


def test_pool_resume_starts_at_checkpoint_sample(both, tmp_path):
    """tests/test_wavefront.py::test_pool_resume_starts_at_checkpoint_sample:
    a pool resumed from a half-way checkpoint renders only the samples
    after it (else they would count twice)."""
    ck = str(tmp_path / "pool.npz")
    s = _settings(spp=4)
    img_full = _render(both, s, "pool")
    half = s.replace(samples_per_pixel=2)
    _render(both, half, checkpoint_path=ck)
    count = both["scene"].triangles.count
    assert _restamp(ck, half, s, count) == 2
    img = _render(both, s, "pool", checkpoint_path=ck)
    np.testing.assert_allclose(img, img_full, atol=1e-6)
    # the pool saved at the end: the checkpoint now stands at spp
    assert ckpt_io.load(ck, ckpt_io.fingerprint(s, count, SEED))[2] == 4


def test_pool_with_never_armed_lanes_equals_wave(both, tmp_path):
    """spp - s_start < sc: a pool of two samples' lanes resumed with one
    sample left arms half its lanes; the other half never carry a path.
    The image is the uninterrupted wave render's, bit for bit."""
    ck = str(tmp_path / "one.npz")
    s = _settings(spp=2)
    one = s.replace(samples_per_pixel=1)
    _render(both, one, checkpoint_path=ck)
    assert _restamp(ck, one, s, both["scene"].triangles.count) == 1
    st = wavefront.RenderStats()
    img = _render(both, s, "pool", checkpoint_path=ck, stats=st)
    np.testing.assert_array_equal(img, _render(both, s))
    assert st.closest_rays > 0


def test_pool_resume_at_spp_does_no_work(both, tmp_path):
    ck = str(tmp_path / "done.npz")
    s = _settings(spp=1)
    img = _render(both, s, "pool", checkpoint_path=ck)
    st = wavefront.RenderStats()
    again = _render(both, s, "pool", checkpoint_path=ck, stats=st)
    np.testing.assert_array_equal(again, img)
    assert st.total_rays == 0 and st.pool_iterations == []


def test_roulette_scheduling_invariance(both, monkeypatch):
    """tests/test_wavefront.py::TestRussianRoulette::test_scheduling_invariance:
    wave sizes, compaction buckets and the pool give the same image for
    the same seed (atol 1e-5 where the f32 sum order differs)."""
    s = _settings(spp=4, bounces=4, rr_start=1)
    ref = _render(both, s, wave_size=1 << 12)
    np.testing.assert_allclose(
        _render(both, s, wave_size=1 << 11, block_size=128), ref, atol=1e-5)
    monkeypatch.setattr(wavefront, "COMPACT_MIN_BUCKET", 64)
    np.testing.assert_array_equal(_render(both, s, wave_size=1 << 12), ref)
    monkeypatch.undo()
    np.testing.assert_allclose(_render(both, s, "pool", wave_size=1 << 12),
                               ref, atol=1e-5)


@pytest.mark.parametrize("rr_start", [0, 1, 2])
def test_bounce_step_per_lane_depth(both, rng, rr_start):
    """A depth tensor gives each lane what an int depth gives it: lanes at
    depths 0, 1 and 2 in one call equal three calls, one a depth (the
    brute-force backend is exact per ray)."""
    from path_tracer_ai_tpu_torch.engine.oracle import camera_rays

    scene, cam = both["scene"], both["camera"]
    n = 96
    keys = threefry.fold_in(threefry.key(SEED), torch.arange(n))
    xs = torch.as_tensor(rng.integers(0, W, n))
    ys = torch.as_tensor(rng.integers(0, H, n))
    o, d = camera_rays(cam, keys, xs, ys, W, H, 16 / 9)
    beta = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32))
    rad = torch.zeros((n, 3))
    alive = torch.as_tensor(rng.uniform(size=n) < 0.9)
    depth = torch.arange(n) % 3
    closest, occlude = tracer.brute_force_backend(scene)
    got = tracer.bounce_step(scene, closest, occlude, o, d, beta, rad, alive,
                             keys, depth, rr_start=rr_start)
    for k in range(3):
        lanes = depth == k
        ref = tracer.bounce_step(
            scene, closest, occlude, o[lanes], d[lanes], beta[lanes],
            rad[lanes], alive[lanes], keys[lanes], k, rr_start=rr_start)
        for a, b in zip(got[:5], ref[:5]):
            assert torch.equal(a[lanes], b), (k, rr_start)
