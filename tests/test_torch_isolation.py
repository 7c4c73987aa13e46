"""The port imports neither JAX nor the JAX package, and loads without a GPU,
nvcc or triton."""

import json
import os
import subprocess
import sys

import pytest

import path_tracer_ai_tpu_torch

PKG_DIR = os.path.dirname(path_tracer_ai_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _all_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__")
                            else mod)
    return sorted(mods)


def test_port_imports_no_jax():
    mods = _all_modules()
    assert "path_tracer_ai_tpu_torch.engine.wavefront" in mods
    assert "path_tracer_ai_tpu_torch.parallel.mesh" in mods
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'path_tracer_ai_tpu' or k.startswith('path_tracer_ai_tpu.'))\n"
        "print(json.dumps({'bad': bad, 'triton': 'triton' in sys.modules}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # Kernel modules import triton/nvcc-built code only when they launch.
    assert res["triton"] is False


def test_port_sources_name_no_jax():
    for mod in _all_modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        src = open(path).read()
        for line in src.splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split()[1], (path, line)
                assert not s.split()[1].startswith("path_tracer_ai_tpu."), (path, line)
                assert s.split()[1] != "path_tracer_ai_tpu", (path, line)


def test_cuda_entry_points_refuse_without_gpu():
    import pytest
    import torch

    from path_tracer_ai_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)


def _build_scene_from_a_file():
    import tempfile

    from path_tracer_ai_tpu_torch.scene.scene import build_scene

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.obj")
        with open(path, "w") as fh:
            fh.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        return build_scene(path).triangles.v0


def _constructor_calls():
    """Each constructor that carries host arrays onto a device, called with
    no device, and a tensor of what it returned. The CLI's device is the
    one both of its modes render on (PT_PLATFORM unset)."""
    import numpy as np
    import torch

    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch import benchmarks, cli, convert
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene import camera, cornell

    f = lambda *shape: np.zeros(shape, np.float32)
    tris = [f(2, 3)] * 6 + [f(2, 2)] * 3 + [np.zeros(2, np.int32)]
    materials = (np.zeros(1, np.int32), f(1, 3), f(1), f(1), f(1))
    lights = (f(1, 3), f(1, 3), f(1))
    accel = ([f(1, 3)] * 2 + [f(1, 4, 3)] * 3 + [np.zeros((1, 4), np.int32)]
             + [f(3)] * 2 + [f(1, 4, 3)] * 2 + [f(1, 1, 3)] * 2)
    return {
        "default_camera": lambda: camera.default_camera().position,
        "make_camera": lambda: camera.make_camera(
            (0, 0, 1), (0, 0, 0), (0, 1, 0), 45.0).forward,
        "scene_from_numpy": lambda: convert.scene_from_numpy(
            tris, materials, lights).triangles.v0,
        "accel_from_numpy": lambda: convert.accel_from_numpy(*accel).v0,
        "camera_from_numpy": lambda: convert.camera_from_numpy(
            f(3), f(3), f(3), f(3), np.float32(45.0)).up,
        "key_from_data": lambda: convert.key_from_data(
            np.zeros(2, np.uint32)),
        "triangles_from_numpy": lambda: triangles_from_numpy(*tris).mat_id,
        "build_scene": _build_scene_from_a_file,
        "build_cornell_scene": lambda: cornell.build_cornell_scene()[0]
        .triangles.v0,
        "cli": lambda: torch.empty(0, device=cli.cli_device()),
        "build_clusters": lambda: build_clusters(SimpleNamespace(
            v0=f(2, 3), v1=f(2, 3) + 1, v2=f(2, 3) + 2), cluster_size=2).v0,
        "build_clusters_morton": lambda: build_clusters(SimpleNamespace(
            v0=f(2, 3), v1=f(2, 3) + 1, v2=f(2, 3) + 2), cluster_size=2,
            method="morton").v0,
        "build_config_scene": lambda: benchmarks.build_config_scene(
            benchmarks.get_configs()["cornell"])[0].triangles.v0,
        "make_mesh": lambda: torch.empty(0, device=mesh.make_mesh(1)
                                         .devices[0][0]),
    }


@pytest.mark.parametrize("name", sorted(_constructor_calls()))
def test_constructors_default_to_the_card(name, monkeypatch):
    """With no device the camera, the array converters, the scene
    constructors, the CLI and the mesh put their tensors on the card, and
    raise where there is none; they never fall back to the CPU."""
    import torch

    monkeypatch.delenv("PT_PLATFORM", raising=False)
    call = _constructor_calls()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
