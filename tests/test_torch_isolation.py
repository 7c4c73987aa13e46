"""The port imports neither JAX nor the JAX package, and loads without a GPU,
nvcc or triton."""

import json
import os
import subprocess
import sys

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
