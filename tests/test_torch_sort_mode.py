"""any_hit_packets' sort_mode and the per-bounce wall log against the JAX
package: each of the four coherence sort keys gives the JAX package's
occlusion bit for bit (and brute force's), the hybrid "packets" shadow
engine takes a sort_mode and renders the "dir" image, and
PT_BOUNCE_TIMING's switch logs one line a bounce."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu_torch.accel import traverse
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import intersect, wavefront
from tests.test_torch_traversal import _setup

T = torch.as_tensor
SORT_MODES = ["dir", "origin", "octorig", "origoct"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sort_mode", SORT_MODES)
def test_any_hit_packets_sort_modes_match_jax(rng, monkeypatch, sort_mode):
    """Each mode sorts by its own key (the one _sort_rays is given) and the
    occlusion equals JAX's any_hit_packets with that mode, and brute
    force."""
    ja, pa, ptris, o, d, tm = _setup(rng, 1200, 128, 64 * 64)
    modes = []
    real = traverse._sort_rays

    def spy(accel, o_, d_, t_, mode):
        modes.append(mode)
        return real(accel, o_, d_, t_, mode)

    monkeypatch.setattr(traverse, "_sort_rays", spy)
    occ_t = traverse.any_hit_packets(pa, T(o), T(d), 1e-3, T(tm),
                                     block_size=64, group_size=2,
                                     sort_mode=sort_mode)
    assert modes == [sort_mode]
    occ_j = np.asarray(jtraverse.any_hit_packets(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm),
        block_size=64, group_size=2, sort_mode=sort_mode))
    assert 0.05 < occ_j.mean() < 0.95
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    brute = intersect.any_hit(ptris, T(o), T(d), 1e-3, T(tm))
    np.testing.assert_array_equal(occ_t.numpy(), brute.numpy())


def test_unknown_sort_mode_raises(rng):
    _ja, pa, _pt, o, d, tm = _setup(rng, 200, 128, 64 * 2)
    with pytest.raises(ValueError, match="sort mode"):
        traverse.any_hit_packets(pa, T(o), T(d), 1e-3, T(tm), block_size=64,
                                 sort_mode="random")


@pytest.fixture(scope="module")
def small():
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    return dict(scene=blob_scene(subdivisions=2, device="cpu"),
                camera=default_camera("cpu"),
                settings=RenderSettings(width=24, height=16,
                                        samples_per_pixel=2, max_bounces=3,
                                        seed=7))


def _render(small, **kw):
    return wavefront.render(small["scene"], small["camera"],
                            small["settings"], wave_size=1 << 10,
                            device="cpu", **kw)


@pytest.mark.parametrize("sort_mode", SORT_MODES[1:])
def test_hybrid_packets_engine_takes_sort_mode(small, monkeypatch, sort_mode):
    """The hybrid "packets" shadow engine passes HYBRID_OCCLUDE_KW's
    sort_mode to any_hit_packets (as the JAX engine does); occlusion is
    exact in any order, so the image is the "dir" image."""
    ref = _render(small)
    seen = []
    real = traverse.any_hit_packets

    def spy(*args, **kw):
        seen.append(kw.get("sort_mode"))
        return real(*args, **kw)

    monkeypatch.setattr(traverse, "any_hit_packets", spy)
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW",
                        dict(engine="packets", group_size=2,
                             sort_mode=sort_mode))
    img = _render(small)
    assert seen and set(seen) == {sort_mode}
    np.testing.assert_array_equal(img, ref)


def test_bounce_timing_logs_one_line_a_bounce(small, monkeypatch, caplog):
    """PT_BOUNCE_TIMING=1 (read at import into _BOUNCE_TIMING): each bounce
    step of each wave logs "bounce d: n lanes, x ms"; off, nothing."""
    caplog.set_level(logging.INFO, logger=wavefront.log.name)
    _render(small)
    assert not [r for r in caplog.records if "lanes," in r.getMessage()]
    monkeypatch.setattr(wavefront, "_BOUNCE_TIMING", True)
    caplog.clear()
    _render(small)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("bounce ")]
    s = small["settings"]
    waves = -(-s.width * s.height * s.samples_per_pixel // (1 << 10))
    assert len(lines) == waves * s.max_bounces
    for i, line in enumerate(lines):
        depth, rest = line[len("bounce "):].split(": ")
        assert int(depth) == i % s.max_bounces
        lanes, ms = rest.split(" lanes, ")
        assert int(lanes) > 0 and ms.endswith(" ms") and float(ms[:-3]) >= 0


def test_bounce_timing_reads_the_environment():
    """The switch is the JAX package's: os.environ["PT_BOUNCE_TIMING"] ==
    "1" when the module is imported."""
    import os
    import subprocess
    import sys

    code = ("from path_tracer_ai_tpu_torch.engine import wavefront as w; "
            "print(w._BOUNCE_TIMING)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for value in ("1", "0"):
        env = dict(os.environ, PT_BOUNCE_TIMING=value, PYTHONPATH=root)
        out[value] = subprocess.run([sys.executable, "-c", code], env=env,
                                    capture_output=True, text=True,
                                    check=True).stdout.strip()
    assert out == {"1": "True", "0": "False"}
