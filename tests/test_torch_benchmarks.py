"""The port's benchmarks module against the JAX package's, and the bench
module's command line (the bench itself needs a GPU: chip_smoke.py runs it).

Configurations, the RMSE helpers, write_obj's files and the benchmark
scenes equal JAX's exactly; the Cornell colour-bleeding and the
RMSE-vs-oracle checks of tests/test_benchmarks.py run on the port at the
same sizes, on the CPU.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu import benchmarks as jbenchmarks
from path_tracer_ai_tpu.scene import procgen as jprocgen
from path_tracer_ai_tpu_torch import benchmarks
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import oracle, wavefront
from path_tracer_ai_tpu_torch.scene import procgen
from path_tracer_ai_tpu_torch.scene.cornell import build_cornell_scene
from path_tracer_ai_tpu_torch.utils.debug import validate_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", [1.0, 0.1, 0.001])
def test_configs_equal_jax(scale):
    mine, ref = benchmarks.get_configs(scale), jbenchmarks.get_configs(scale)
    assert list(mine) == list(ref)
    assert set(mine) == {"cpu-ref", "cornell", "dielectric", "gpu-parity",
                         "4k"}
    for name, cfg in mine.items():
        r = ref[name]
        assert (cfg.name, cfg.scene_kind, cfg.dielectric, cfg.progressive,
                cfg.tile_devices) == (r.name, r.scene_kind, r.dielectric,
                                      r.progressive, r.tile_devices)
        for field in ("width", "height", "samples_per_pixel", "max_bounces",
                      "gamma", "aspect_mode", "seed", "rr_start"):
            assert getattr(cfg.settings, field) == getattr(r.settings, field)


def test_rmse_equals_jax(rng):
    a = rng.uniform(size=(8, 8, 3))
    b = a + rng.normal(scale=0.05, size=a.shape)
    assert benchmarks.rmse(a, a) == 0.0
    assert benchmarks.rmse(a, b) == jbenchmarks.rmse(a, b)
    assert 0.09 < benchmarks.rmse(np.ones((8, 8, 3)),
                                  np.ones((8, 8, 3)) * 1.1) < 0.11


@pytest.mark.parametrize("subdivisions", [1, 3])
def test_write_obj_byte_identical(tmp_path, subdivisions):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = jprocgen.write_obj(str(tmp_path / "j" / "blob.obj"), subdivisions)
    pt = procgen.write_obj(str(tmp_path / "t" / "blob.obj"), subdivisions)
    assert os.path.basename(pt) == "blob.obj"
    for name in ("blob.obj", "blob.mtl"):
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name
    assert "Ni 1.45" in (tmp_path / "t" / "blob.mtl").read_text()


@pytest.mark.parametrize("name", ["cpu-ref", "dielectric", "cornell"])
def test_build_config_scene_equals_jax(name):
    cfg = benchmarks.get_configs()[name]
    scene, cam = benchmarks.build_config_scene(cfg, subdivisions=2,
                                               device="cpu")
    jscene, jcam = jbenchmarks.build_config_scene(
        jbenchmarks.get_configs()[name], subdivisions=2)
    for part in ("triangles", "materials", "lights"):
        for a, b in zip(getattr(scene, part), getattr(jscene, part)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=part)
    for a, b in zip(cam, jcam):
        np.testing.assert_array_equal(np.asarray(a.cpu() if torch.is_tensor(a)
                                                 else a), np.asarray(b))


def test_cornell_render_has_color_bleeding():
    """tests/test_benchmarks.py's GI check on the port: indirect light near
    the red wall is redder than near the green wall."""
    scene, camera = build_cornell_scene(device="cpu")
    s = RenderSettings(width=64, height=64, samples_per_pixel=32,
                       max_bounces=4, seed=0)
    img = wavefront.render(scene, camera, s, wave_size=1 << 13,
                           block_size=64, device="cpu")
    audit = validate_image(img)
    assert audit.finite and audit.n_magenta == 0
    left = img[:, 4:18].mean(axis=(0, 1))    # near the red wall
    right = img[:, -18:-4].mean(axis=(0, 1))  # near the green wall
    assert left[0] / max(left[1], 1e-6) > right[0] / max(right[1], 1e-6)
    assert img.mean() > 0.01


def test_rmse_vs_oracle_small():
    """tests/test_benchmarks.py's headline accuracy check on the port: the
    wavefront image sits at the oracle's own different-seed noise floor,
    and rmse_vs_oracle is that same comparison."""
    scene, camera = build_cornell_scene(device="cpu")
    s = RenderSettings(width=32, height=32, samples_per_pixel=48,
                       max_bounces=3, seed=5)
    o_a = oracle.render(scene, camera, s, device="cpu")
    o_b = oracle.render(scene, camera, s.replace(seed=6), device="cpu")
    w_a = wavefront.render(scene, camera, s, device="cpu")
    noise_floor = benchmarks.rmse(o_a, o_b)
    r = benchmarks.rmse(w_a, o_b)
    assert r < noise_floor * 1.05, f"RMSE {r} vs noise floor {noise_floor}"
    assert abs(w_a.mean() - o_b.mean()) / o_b.mean() < 0.05
    assert benchmarks.rmse_vs_oracle(scene, camera, s, device="cpu") == r


def test_run_config_4k_renders_through_the_mesh(monkeypatch):
    """run_config("4k") (once raising: tile_devices) shards over 8 devices,
    here 8 virtual CPU entries, cut to 32x18 and 1 spp on a blob of subdiv
    1: the image equals the single-device render of the same scene bit for
    bit (one sample a pixel)."""
    from path_tracer_ai_tpu_torch.parallel import mesh

    real = benchmarks.get_configs

    def small(scale=1.0):
        cfgs = real(scale)
        cfgs["4k"].settings = cfgs["4k"].settings.replace(width=32,
                                                          height=18)
        return cfgs

    tiled = []
    real_tiled = mesh.render_tiled

    def spy(*a, **k):
        tiled.append(k["n_devices"])
        return real_tiled(*a, **k)

    monkeypatch.setattr(benchmarks, "get_configs", small)
    monkeypatch.setattr(mesh, "render_tiled", spy)
    img, stats = benchmarks.run_config("4k", scale=1 / 1024, subdivisions=1,
                                       device="cpu")
    assert tiled == [8]
    cfg = small(1 / 1024)["4k"]
    assert (cfg.settings.samples_per_pixel, cfg.settings.max_bounces) == (
        1, 16)
    scene, camera = benchmarks.build_config_scene(cfg, 1, device="cpu")
    ref = wavefront.render(scene, camera, cfg.settings, device="cpu")
    np.testing.assert_array_equal(img, ref)
    assert stats.total_rays > 0


def test_run_config_renders_on_the_cpu(monkeypatch):
    """run_config end to end, the Cornell configuration cut to 32x32."""
    real = benchmarks.get_configs

    def small(scale=1.0):
        cfgs = real(scale)
        cfgs["cornell"].settings = cfgs["cornell"].settings.replace(
            width=32, height=32)
        return cfgs

    monkeypatch.setattr(benchmarks, "get_configs", small)
    img, stats = benchmarks.run_config("cornell", scale=1 / 64,
                                       device="cpu")
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert stats.total_rays > 0 and img.mean() > 0.01


def test_bench_flags_are_the_root_bench_flags():
    """The bench's flags are the root bench.py's, with the same defaults."""
    from path_tracer_ai_tpu_torch import bench

    args = bench.parse_args([])
    assert (args.width, args.height, args.spp, args.bounces, args.subdiv,
            args.quick, args.backend, args.cluster_size) == (
                1920, 1080, 2, 5, 6, False, None, 128)
    quick = bench.parse_args(["--quick", "--backend", "worklist"])
    assert (quick.width, quick.height, quick.spp, quick.subdiv,
            quick.backend) == (320, 180, 2, 3, "worklist")


def test_bench_module_needs_a_gpu():
    """Without a GPU (none here, or hidden) the bench prints nothing on
    stdout and exits 1: it never measures the CPU."""
    out = subprocess.run([sys.executable, "-m",
                          "path_tracer_ai_tpu_torch.bench", "--quick"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA device" in out.stderr
