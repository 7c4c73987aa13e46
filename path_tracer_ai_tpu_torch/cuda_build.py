"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C entry point and becomes
`_build/<name>-<hash>.so` (or the same under $PT_CUDA_BUILD_DIR), where the hash covers the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt at its
next use and an unchanged one never is. Nothing here runs at import time:
the package imports on machines without nvcc or a GPU, and a build happens
at a kernel's first launch (or ahead of it, through `build_all`).

Flags: sm_90a, -O3, and --fmad=false so that `x*y - z*w` is never
contracted into an FMA (the kernels must match their plain PyTorch
versions bit for bit); no --use_fast_math, so division stays IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
# PT_CUDA_BUILD_DIR moves the libraries out of the package (an installed
# package may lie in a directory its user cannot write).
BUILD_DIR = (os.environ.get("PT_CUDA_BUILD_DIR")
             or os.path.join(_PKG_DIR, "_build"))

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# The entry points' answer to a shape that no tuned instance is compiled
# for (no cudaError_t is negative); the wrappers then launch the generic
# instance.
NO_INSTANCE = -1

_libs: dict = {}
_load_lock = threading.Lock()  # the mesh's workers load from several threads
build_log: dict = {}  # name -> {"seconds": float, "ptxas": str} of this process


def sources() -> list:
    """The names of every kernel source under csrc/ (<name>.cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def header_float(name: str, header: str = "mt.cuh") -> float:
    """The value of `#define <name> <hex float>f` in csrc/<header>: a
    constant that the kernels and their plain versions share, defined once,
    in the kernels' header."""
    with open(os.path.join(CSRC_DIR, header)) as fh:
        for line in fh:
            parts = line.split()
            if parts[:2] == ["#define", name]:
                return float.fromhex(parts[2].rstrip("f"))
    raise KeyError(f"{name} is not defined in csrc/{header}")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names) -> dict:
    """Build every missing library, one nvcc per source, all at once.
    Returns {name: seconds} for the libraries built by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    built = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        built[name] = time.perf_counter() - t0
        build_log[name] = {"seconds": built[name], "ptxas": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(library_path(name))
                _libs[name] = lib
    return lib


def launch(fn, dev, *args) -> int:
    """fn(*args, stream) with `dev` the current device and `stream` its
    current stream; returns fn's error code. The runtime launches a kernel
    on the current device, which torch's own ops leave unchanged, so a
    launch for tensors on another card must switch to it (a stream of
    another device is refused, and the default stream's handle would name
    the current device's)."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def launch_instance(tuned, generic, dev, args, generic_args=None,
                    use_generic: bool = False):
    """Launches a kernel's tuned instance, tuned(*args), or its generic one,
    generic(*(generic_args or args)), where the tuned entry point has no
    instance for these shapes (NO_INSTANCE) or use_generic asks for it.
    Returns (error code, whether the generic instance ran)."""
    if not use_generic:
        err = launch(tuned, dev, *args)
        if err != NO_INSTANCE:
            return err, False
    return launch(generic, dev, *(generic_args or args)), True
