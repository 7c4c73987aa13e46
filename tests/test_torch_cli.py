"""The port's CLI and the utils it calls.

Every case of tests/test_cli.py runs against path_tracer_ai_tpu_torch.cli
with PT_PLATFORM=cpu (the port's switch to the CPU; without it the CLI
needs a GPU). The port's PNG is held against the JAX CLI's within one
8-bit level on >= 99% of pixels (the float paths differ, test_torch_render).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch import cli
from path_tracer_ai_tpu_torch.cli import build_parser, main
from path_tracer_ai_tpu_torch.engine import oracle, wavefront
from path_tracer_ai_tpu_torch.io.png import read_png
from path_tracer_ai_tpu_torch.scene.procgen import write_blob_obj

OBJ = """
v -1 0 -1
v 1 0 -1
v 0 2 -1
f 1 2 3
"""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def obj_path(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(OBJ)
    return str(p)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PT_PLATFORM", "cpu")


# --- tests/test_cli.py, case by case -----------------------------------------

def test_defaults_match_reference():
    args = build_parser().parse_args([])
    assert args.mode == "gpu"
    assert (args.width, args.height) == (800, 450)
    assert (args.samples, args.bounces) == (100, 5)
    assert args.gamma == 2.2
    assert args.input == "IronMan/IronMan.obj"
    assert args.output == "output.png"


def test_flags_match_jax_cli():
    from path_tracer_ai_tpu.cli import build_parser as jparser

    def table(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices)
                for a in p._actions}

    assert table(build_parser()) == table(jparser())


def test_h_is_height_not_help():
    args = build_parser().parse_args(["-h", "99"])
    assert args.height == 99


def test_cpu_mode_end_to_end(obj_path, tmp_path, on_cpu):
    out = str(tmp_path / "o.png")
    rc = main(["-m", "cpu", "-w", "24", "-h", "16", "-s", "2", "-b", "2",
               "-i", obj_path, "-o", out])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (16, 24, 3)


def test_tpu_mode_end_to_end(obj_path, tmp_path, on_cpu):
    out = str(tmp_path / "o2.png")
    rc = main(["-m", "tpu", "-w", "24", "-h", "16", "-s", "2", "-b", "2",
               "-i", obj_path, "-o", out, "--validate"])
    assert rc == 0
    assert read_png(out).shape == (16, 24, 3)


def test_same_seed_modes_agree(obj_path, tmp_path, on_cpu):
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    common = ["-w", "20", "-h", "12", "-s", "2", "-b", "2", "-i", obj_path,
              "--seed", "9"]
    assert main(["-m", "cpu", "-o", a] + common) == 0
    assert main(["-m", "tpu", "-o", b] + common) == 0
    np.testing.assert_array_equal(read_png(a), read_png(b))


@pytest.mark.parametrize("backend", ["worklist", "pairs", "packets",
                                     "ctiles", "perray", "kslots"])
def test_ported_backend_flags_render(tmp_path, on_cpu, backend):
    """--backend worklist|pairs|packets|ctiles|perray|kslots (once raising
    as unported) render a blob OBJ to the same PNG as -m cpu."""
    obj = str(tmp_path / "blob.obj")
    write_blob_obj(obj, subdivisions=1)
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    common = ["-w", "20", "-h", "12", "-s", "2", "-b", "3", "-i", obj,
              "--seed", "9"]
    assert main(["-m", "cpu", "-o", a] + common) == 0
    assert main(["-m", "gpu", "--backend", backend, "-o", b] + common) == 0
    np.testing.assert_array_equal(read_png(a), read_png(b))


@pytest.mark.parametrize("flags", [["--tile-devices", "2"],
                                   ["--scheduler", "pool"]])
def test_tile_devices_and_pool_flags_render(tmp_path, on_cpu, flags):
    """--tile-devices N (a mesh of N virtual CPU entries) and --scheduler
    pool (once raising as unported) render a blob OBJ to the same PNG as
    -m cpu (2 spp: the sums are bitwise the single device's)."""
    obj = str(tmp_path / "blob.obj")
    write_blob_obj(obj, subdivisions=1)
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    common = ["-w", "20", "-h", "12", "-s", "2", "-b", "3", "-i", obj,
              "--seed", "9"]
    assert main(["-m", "cpu", "-o", a] + common) == 0
    assert main(["-m", "gpu", "-o", b] + flags + common) == 0
    np.testing.assert_array_equal(read_png(a), read_png(b))


def test_missing_input_fails(tmp_path, on_cpu):
    rc = main(["-i", str(tmp_path / "none.obj"), "-o", str(tmp_path / "x.png")])
    assert rc == 1


def test_checkpoint_roundtrip(obj_path, tmp_path, on_cpu):
    out = str(tmp_path / "c.png")
    ck = str(tmp_path / "c.ckpt")
    args = ["-m", "tpu", "-w", "16", "-h", "9", "-s", "3", "-b", "2",
            "-i", obj_path, "-o", out, "--checkpoint", ck]
    assert main(args) == 0
    first = read_png(out)
    # resume-from-complete: instant, identical output
    assert main(args) == 0
    np.testing.assert_array_equal(first, read_png(out))


# --- the port against the JAX CLI --------------------------------------------

@pytest.mark.parametrize("mode,extra", [("cpu", []), ("gpu", []),
                                        ("gpu", ["--rr", "1"])])
def test_png_matches_jax_cli(tmp_path, on_cpu, mode, extra):
    from path_tracer_ai_tpu.cli import main as jmain

    obj = str(tmp_path / "blob.obj")
    write_blob_obj(obj, subdivisions=2)
    common = ["-m", mode, "-w", "32", "-h", "18", "-s", "2", "-b", "3",
              "-i", obj, "--seed", "3"] + extra
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert main(common + ["-o", a]) == 0
    assert jmain(common + ["-o", b]) == 0
    pa, pb = read_png(a).astype(int), read_png(b).astype(int)
    assert (pb.max(-1) > 0).mean() > 0.5
    within = (np.abs(pa - pb).max(-1) <= 1).mean()
    assert within >= 0.99, within


def test_port_mode_images_equal_on_a_blob(tmp_path, on_cpu):
    """tests/test_cli.py::test_same_seed_modes_agree on the blob OBJ (the
    chip smoke test's cli phase holds the same on the card)."""
    obj = str(tmp_path / "blob.obj")
    write_blob_obj(obj, subdivisions=2)
    common = ["-w", "24", "-h", "14", "-s", "2", "-b", "3", "-i", obj]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert main(["-m", "cpu", "-o", a] + common) == 0
    assert main(["-m", "gpu", "-o", b] + common) == 0
    np.testing.assert_array_equal(read_png(a), read_png(b))


def test_negative_components_are_the_references(tmp_path):
    """The audit's negative components on a blob OBJ (the 1080p CLI render
    on the card counts ~300) are the JAX oracle's, at the same places."""
    from path_tracer_ai_tpu.config import RenderSettings as JSettings
    from path_tracer_ai_tpu.engine import oracle as joracle
    from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
    from path_tracer_ai_tpu.scene.scene import build_scene as jbuild
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import build_scene
    from path_tracer_ai_tpu_torch.utils.debug import validate_image

    obj = str(tmp_path / "blob.obj")
    write_blob_obj(obj, subdivisions=2)
    kw = dict(width=48, height=27, samples_per_pixel=2, max_bounces=5)
    img = oracle.render(build_scene(obj, device="cpu"), default_camera("cpu"),
                        RenderSettings(**kw), device="cpu")
    ref = np.asarray(joracle.render(jbuild(obj), jcamera(), JSettings(**kw)))
    assert validate_image(img).n_negative > 0
    np.testing.assert_array_equal(img < 0, ref < 0)


# --- the missing fallback ------------------------------------------------------

def test_accelerated_failure_returns_1_without_oracle_rerun(
        obj_path, tmp_path, on_cpu, monkeypatch):
    calls = []

    def broken(*a, **k):
        calls.append("wavefront")
        raise RuntimeError("kernel failed to launch")

    def oracle_render(*a, **k):
        calls.append("oracle")
        raise AssertionError("the CLI fell back to the oracle")

    monkeypatch.setattr(wavefront, "render", broken)
    monkeypatch.setattr(oracle, "render", oracle_render)
    out = tmp_path / "x.png"
    assert main(["-m", "gpu", "-i", obj_path, "-o", str(out)]) == 1
    assert calls == ["wavefront"]
    assert not out.exists()


def test_needs_a_gpu_without_pt_platform(obj_path, tmp_path, monkeypatch):
    monkeypatch.delenv("PT_PLATFORM", raising=False)
    out = tmp_path / "x.png"
    if torch.cuda.is_available():
        assert cli.cli_device().type == "cuda"
    else:
        for mode in ("cpu", "gpu"):
            assert main(["-m", mode, "-i", obj_path, "-o", str(out)]) == 1
        assert not out.exists()


def test_runs_as_a_module(obj_path, tmp_path):
    out = tmp_path / "m.png"
    env = dict(os.environ, PYTHONPATH=REPO, PT_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "path_tracer_ai_tpu_torch.cli", "-m", "gpu",
         "-w", "16", "-h", "9", "-s", "1", "-b", "2", "-i", obj_path,
         "-o", str(out), "--validate"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Image audit: ImageAudit(finite=True" in res.stdout
    assert "Rendering completed in" in res.stdout
    assert read_png(str(out)).shape == (9, 16, 3)


def test_profile_writes_a_chrome_trace(obj_path, tmp_path, on_cpu):
    prof = tmp_path / "prof"
    assert main(["-m", "gpu", "-w", "8", "-h", "6", "-s", "1", "-b", "1",
                 "-i", obj_path, "-o", str(tmp_path / "p.png"),
                 "--profile", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "closest_wave" in names and "shadow_wave" in names


# --- utils ----------------------------------------------------------------------

def test_validate_image_matches_jax():
    from path_tracer_ai_tpu.utils.debug import validate_image as jvalidate
    from path_tracer_ai_tpu_torch.utils.debug import validate_image

    img = np.zeros((4, 4, 3), np.float32)
    img[0, 0] = np.nan
    img[1, 1] = np.inf
    img[2, 2] = (1.0, 0.0, 1.0)  # magenta sentinel
    img[3, 3, 1] = -0.5
    audit = validate_image(img)
    assert tuple(audit) == tuple(jvalidate(img))
    assert not audit.finite
    assert (audit.n_nan, audit.n_inf, audit.n_magenta, audit.n_negative) == (
        3, 3, 1, 1)
    assert validate_image(np.full((4, 4, 3), 0.5, np.float32)).finite


def test_assert_finite_warns_and_returns_its_input(caplog):
    from path_tracer_ai_tpu_torch.utils.debug import assert_finite

    x = torch.tensor([1.0, float("nan"), float("inf"), 2.0])
    with caplog.at_level("WARNING", logger="path_tracer_ai_tpu_torch"):
        assert assert_finite(x, "beta") is x
        assert_finite(torch.ones(3), "ok")
    assert [r.getMessage() for r in caplog.records] == [
        "2 non-finite elements in beta"]


def test_timer_and_timed():
    from path_tracer_ai_tpu_torch.utils.profiling import Timer, timed

    t = Timer()
    with t.section("x", sync=torch.ones(3)):
        sum(range(1000))
    with t.section("x"):
        pass
    assert t.counts["x"] == 2 and t.sections["x"] >= 0
    assert "x:" in t.report() and "2 calls" in t.report()
    result, per_call = timed(lambda v: v * 2, torch.ones(8), n=2)
    assert per_call >= 0
    np.testing.assert_array_equal(result.numpy(), 2.0 * np.ones(8))


def test_trace_writes_its_file(tmp_path, caplog):
    from path_tracer_ai_tpu_torch.utils.profiling import trace

    with caplog.at_level("INFO", logger="path_tracer_ai_tpu_torch"):
        with trace(str(tmp_path / "t")) as d:
            torch.ones(64).sum()
    path = tmp_path / "t" / "trace.json"
    assert d == str(tmp_path / "t")
    assert json.loads(path.read_text())["traceEvents"]
    assert f"Profiler trace written to {path}" in caplog.text


def test_device_utils(rng):
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene
    from path_tracer_ai_tpu_torch.utils.device import (
        device_memory_stats,
        download,
        nbytes_of,
        scene_to_device,
        upload,
    )

    x = rng.standard_normal((16, 3)).astype(np.float32)
    t = upload(x, device="cpu")
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(download(t), x)
    tree = {"a": torch.zeros((10, 3)), "b": (torch.zeros(5, dtype=torch.int32),
                                             np.zeros(2, np.float64))}
    assert nbytes_of(tree) == 10 * 3 * 4 + 5 * 4 + 16
    s = blob_scene(1, device="cpu")
    placed = scene_to_device(s, device="cpu")
    assert placed.triangles.count == s.triangles.count
    assert nbytes_of(placed) == nbytes_of(s)
    assert device_memory_stats("cpu") == {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small eager renders: the suite
    runs in parallel workers, where more threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
