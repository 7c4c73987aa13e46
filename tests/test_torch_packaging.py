"""The port installs whole: a wheel built from the tree carries every CUDA
source under path_tracer_ai_tpu_torch/csrc (the kernels are built from
them at first use) and the `torch` extra, and PT_CUDA_BUILD_DIR moves the
built libraries out of the package."""

import importlib.util
import os
import shutil
import subprocess
import sys
import zipfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "path_tracer_ai_tpu_torch"


def test_wheel_holds_every_cuda_source(tmp_path):
    if importlib.util.find_spec("pip") is None or \
            importlib.util.find_spec("setuptools") is None:
        pytest.skip("pip or setuptools is not installed")
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(ROOT, "pyproject.toml"), src)
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    for pkg in ("path_tracer_ai_tpu", PORT):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg, ignore=ignore)
    out = tmp_path / "wheel"
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", str(src),
                    "-w", str(out)], check=True, cwd=tmp_path,
                   capture_output=True, text=True)
    (wheel,) = out.glob("*.whl")
    with zipfile.ZipFile(wheel) as zf:
        names = set(zf.namelist())
        meta = next(zf.read(n).decode() for n in names
                    if n.endswith(".dist-info/METADATA"))
    csrc = os.path.join(ROOT, PORT, "csrc")
    sources = sorted(f for f in os.listdir(csrc)
                     if f.endswith((".cu", ".cuh")))
    assert any(f.endswith(".cuh") for f in sources)
    assert len([f for f in sources if f.endswith(".cu")]) == 10
    for f in sources:
        assert f"{PORT}/csrc/{f}" in names, f
    assert f"{PORT}/cuda_build.py" in names
    assert "Provides-Extra: torch" in meta
    assert 'Requires-Dist: torch; extra == "torch"' in meta


def test_build_dir_override(tmp_path):
    """PT_CUDA_BUILD_DIR, read at import, holds the libraries; unset, they
    go to the package's own _build (which .gitignore lists)."""
    code = ("from path_tracer_ai_tpu_torch import cuda_build as c; "
            "print(c.BUILD_DIR); print(c.library_path('ctiles_sweep'))")
    env = {k: v for k, v in os.environ.items() if k != "PT_CUDA_BUILD_DIR"}
    env["PYTHONPATH"] = ROOT
    run = lambda e: subprocess.run([sys.executable, "-c", code], env=e,
                                   capture_output=True, text=True,
                                   check=True).stdout.split()
    build_dir, lib = run(dict(env, PT_CUDA_BUILD_DIR=str(tmp_path)))
    assert build_dir == str(tmp_path)
    assert os.path.dirname(lib) == str(tmp_path)
    assert os.path.basename(lib).startswith("ctiles_sweep-")
    build_dir, _lib = run(env)
    assert build_dir == os.path.join(ROOT, PORT, "_build")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert f"{PORT}/_build/" in fh.read().split()
