"""Checkpointed progressive accumulation in the port (io.checkpoint and
wavefront.render's checkpoint_path / checkpoint_every), and the oracle's
batching options.

The fingerprint strings and the npz layout are the JAX package's, so a
checkpoint written by either package loads in the other. A render stopped
at a checkpoint and resumed equals the uninterrupted render bitwise: the
sums are carried in f32 exactly, and each pass adds to them in the same
order either way.
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.config import RenderSettings as JSettings
from path_tracer_ai_tpu.engine import oracle as joracle
from path_tracer_ai_tpu.io import checkpoint as jckpt
from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import oracle, wavefront
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt
from tests.test_torch_render import _assert_close, both  # noqa: F401

W, H, SPP, BOUNCES, SEED = 32, 18, 4, 3, 5
NPIX = W * H


def _settings(cls=RenderSettings, **kw):
    return cls(**{**dict(width=W, height=H, samples_per_pixel=SPP,
                         max_bounces=BOUNCES, seed=SEED), **kw})


def _render(b, settings=None, **kw):
    # waves of one pass over every pixel: SPP passes of one sample each
    return wavefront.render(b["scene"], b["camera"], settings or _settings(),
                            accel=b["accel"], accel_closest=b["accel_c"],
                            wave_size=NPIX, device="cpu", **kw)


@pytest.fixture(scope="module")
def full(both):
    return _render(both)


@pytest.mark.parametrize("kw", [
    {}, dict(rr_start=2), dict(aspect_mode="true", max_bounces=7),
    dict(width=7, height=5, samples_per_pixel=1, rr_start=11)])
def test_fingerprint_matches_jax(kw):
    fp = ckpt.fingerprint(_settings(**kw), 1234, 99)
    assert fp == jckpt.fingerprint(_settings(JSettings, **kw), 1234, 99)
    assert ("|rr" in fp) == ("rr_start" in kw)


@pytest.mark.parametrize("writer,reader", [(ckpt, jckpt), (jckpt, ckpt)])
def test_checkpoints_cross_load(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    acc = rng.standard_normal((NPIX, 3)).astype(np.float32)
    cnt = rng.integers(0, 9, NPIX).astype(np.int32)
    fp = ckpt.fingerprint(_settings(rr_start=1), 77, 5)
    path = str(tmp_path / "x.npz")
    writer.save(path, acc, cnt, 3, fp)
    assert reader.peek_fingerprint(path) == fp
    a, c, nxt = reader.load(path, fp)
    np.testing.assert_array_equal(a, acc)
    np.testing.assert_array_equal(c, cnt)
    assert nxt == 3 and a.dtype == np.float32 and c.dtype == np.int32
    assert reader.load(path, fp + "x") is None


@pytest.mark.parametrize("stored,like,spp", [
    ("v1|8x8|spp32|b5|afixed|t9|s0", "v1|8x8|spp64|b5|afixed|t9|s0", 32),
    ("v1|8x8|spp32|b5|afixed|t9|s0", "v1|8x8|spp32|b5|afixed|t9|s0", None),
    ("v1|8x8|spp32|b5|afixed|t9|s0", "v1|8x8|spp64|b4|afixed|t9|s0", None),
    ("v1|8x8|spp32|b5|afixed|t9|s0|rr1", "v1|8x8|spp64|b5|afixed|t9|s0",
     None),
    ("v1|8x8|sppX|b5|afixed|t9|s0", "v1|8x8|spp64|b5|afixed|t9|s0", None),
])
def test_compatible_spp_matches_jax(stored, like, spp):
    assert ckpt.compatible_spp(stored, like) == spp
    assert jckpt.compatible_spp(stored, like) == spp


def test_missing_or_corrupt_checkpoint(tmp_path):
    assert ckpt.load(str(tmp_path / "none.npz"), "fp") is None
    assert ckpt.peek_fingerprint(str(tmp_path / "none.npz")) is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    assert ckpt.load(str(bad), "fp") is None


def test_stopped_and_resumed_render_is_bitwise(both, full, tmp_path):
    """Render 2 of 4 samples into a checkpoint, restamp it with the 4-sample
    fingerprint (tests/test_wavefront.py's emulation of a stop), resume."""
    path = str(tmp_path / "r.npz")
    _render(both, _settings(samples_per_pixel=2), checkpoint_path=path)
    n_tri = both["scene"].triangles.count
    acc, cnt, nxt = ckpt.load(path, ckpt.fingerprint(
        _settings(samples_per_pixel=2), n_tri, SEED))
    assert nxt == 2
    ckpt.save(path, acc, cnt, nxt, ckpt.fingerprint(_settings(), n_tri, SEED))
    np.testing.assert_array_equal(_render(both, checkpoint_path=path), full)
    # the finished render saved itself: resuming again traces nothing
    stats = wavefront.RenderStats()
    np.testing.assert_array_equal(
        _render(both, checkpoint_path=path, stats=stats), full)
    assert stats.total_rays == 0


def test_killed_render_resumes_from_checkpoint_every(both, full, tmp_path,
                                                     monkeypatch):
    """checkpoint_every=1 saves after each pass; a render stopped after
    its second save resumes from sample 2 and gives the full image."""
    path = str(tmp_path / "k.npz")
    saves = []
    real_save = ckpt.save

    def save_then_stop(*args):
        real_save(*args)
        saves.append(args[3])
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        _render(both, checkpoint_path=path, checkpoint_every=1)
    monkeypatch.undo()
    assert saves == [1, 2]
    stats = wavefront.RenderStats()
    np.testing.assert_array_equal(
        _render(both, checkpoint_path=path, stats=stats), full)
    full_stats = wavefront.RenderStats()
    _render(both, stats=full_stats)
    assert 0 < stats.closest_rays < full_stats.closest_rays


@pytest.mark.parametrize("kw", [dict(width=16, height=9), dict(rr_start=1),
                                dict(seed=6)])
def test_mismatched_checkpoint_is_ignored(both, full, tmp_path, kw):
    path = str(tmp_path / "m.npz")
    _render(both, _settings(**kw), checkpoint_path=path)
    stale = ckpt.peek_fingerprint(path)
    img = _render(both, checkpoint_path=path)
    np.testing.assert_array_equal(img, full)
    assert ckpt.peek_fingerprint(path) != stale  # overwritten at the end


def test_progress_lines(both, caplog):
    with caplog.at_level("INFO", logger="path_tracer_ai_tpu_torch"):
        _render(both, show_progress=True)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Rendering progress")]
    assert lines == [f"Rendering progress: {25 * k}% ({k}/4 samples)"
                     for k in range(1, 5)]


# --- the oracle's batching options -------------------------------------------

@pytest.fixture(scope="module")
def oracle_ref(both):
    return oracle.render(both["scene"], both["camera"], _settings(),
                         device="cpu")


@pytest.mark.parametrize("kw", [dict(chunk_pixels=100), dict(tri_chunk=7),
                                dict(spp_chunk=SPP), dict(spp_chunk=9),
                                dict(spp_chunk=1), dict(spp_chunk=3)])
def test_oracle_batching_is_bitwise(both, oracle_ref, full, kw):
    """Pixel batches and triangle chunks change no sample and no sum. An
    spp_chunk whose blocks after the first hold one sample adds the same
    values in the same order (0 + x is exact)."""
    img = oracle.render(both["scene"], both["camera"], _settings(),
                        device="cpu", **kw)
    np.testing.assert_array_equal(img, oracle_ref)
    np.testing.assert_array_equal(img, full)


def test_oracle_spp_chunk_regroups_the_sums(both, oracle_ref):
    """spp_chunk=2 of 4 samples sums (r0 + r1) + (r2 + r3) in place of
    ((r0 + r1) + r2) + r3: the same samples in another f32 grouping, so the
    image is within summation order of the one-block image, as across wave
    sizes."""
    img = oracle.render(both["scene"], both["camera"], _settings(),
                        spp_chunk=2, device="cpu")
    np.testing.assert_allclose(img, oracle_ref, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(img, oracle_ref)


def test_oracle_spp_chunk_matches_jax(both):
    ref = np.asarray(joracle.render(both["jscene"], jcamera(),
                                    _settings(JSettings, samples_per_pixel=3),
                                    spp_chunk=2, chunk_pixels=256))
    img = oracle.render(both["scene"], both["camera"],
                        _settings(samples_per_pixel=3), spp_chunk=2,
                        chunk_pixels=256, device="cpu")
    _assert_close(img, ref)


def test_oracle_progress_lines(both, caplog):
    with caplog.at_level("INFO", logger="path_tracer_ai_tpu_torch"):
        oracle.render(both["scene"], both["camera"],
                      _settings(samples_per_pixel=1, max_bounces=1),
                      chunk_pixels=256, show_progress=True, device="cpu")
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Rendering progress")]
    assert lines == ["Rendering progress: 44% (256/576 pixels)",
                     "Rendering progress: 88% (512/576 pixels)",
                     "Rendering progress: 100% (576/576 pixels)"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small eager renders: the suite
    runs in parallel workers, where more threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
