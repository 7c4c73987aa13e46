"""Progressive-render checkpoints: save and resume (counterpart of
io/checkpoint.py).

The reference renders one shot and writes the framebuffer once
(renderer.cpp:5-21). Here the radiance sums, the valid-sample counts and the
next sample index are kept after a sample pass, in an npz keyed by a
fingerprint of the settings, so a stale checkpoint is never reused. The
layout and the fingerprint strings are the JAX package's, so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def fingerprint(settings, n_triangles: int, seed: int) -> str:
    fp = (
        f"v1|{settings.width}x{settings.height}|spp{settings.samples_per_pixel}"
        f"|b{settings.max_bounces}|a{settings.aspect_mode}|t{n_triangles}|s{seed}"
    )
    # Appended only when on, so checkpoints written without Russian
    # roulette keep their fingerprint.
    rr = getattr(settings, "rr_start", 0)
    if rr:
        fp += f"|rr{rr}"
    return fp


def save(path: str, acc: np.ndarray, cnt: np.ndarray, next_sample: int,
         fp: str) -> None:
    """Write atomically: a temporary .npz beside `path`, then a rename."""
    tmp = path + ".tmp"
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"  # numpy adds it
    np.savez_compressed(
        tmp, acc=acc, cnt=cnt, next_sample=np.int64(next_sample),
        fingerprint=np.bytes_(fp.encode()),
    )
    os.replace(actual_tmp, path)
    log.info("Checkpoint saved: %s (next sample %d)", path, next_sample)


def peek_fingerprint(path: str) -> Optional[str]:
    """A checkpoint's stored fingerprint alone (no array data)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return bytes(z["fingerprint"]).decode()
    except (OSError, KeyError, ValueError) as e:
        log.warning("Failed to peek checkpoint %s: %s", path, e)
        return None


def compatible_spp(stored_fp: str, like_fp: str) -> Optional[int]:
    """stored_fp's spp if it differs from like_fp ONLY in the sppN field,
    else None.

    A render stopped mid-way leaves its checkpoint stamped with the spp of
    the render it was performing; such a checkpoint resumes by rendering to
    that spp instead of starting over."""
    a, b = stored_fp.split("|"), like_fp.split("|")
    if len(a) != len(b):
        return None
    spp = None
    for x, y in zip(a, b):
        if x == y:
            continue
        if x.startswith("spp") and y.startswith("spp"):
            try:
                spp = int(x[3:])
            except ValueError:
                return None
        else:
            return None
    return spp


def load(path: str, fp: str) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(acc [P,3] f32, cnt [P] i32, next sample) if `path` holds a
    checkpoint of fingerprint `fp`, else None."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored = bytes(z["fingerprint"]).decode()
            if stored != fp:
                log.warning(
                    "Checkpoint %s has mismatched settings (%s != %s); ignoring",
                    path, stored, fp,
                )
                return None
            return (
                np.asarray(z["acc"], np.float32),
                np.asarray(z["cnt"], np.int32),
                int(z["next_sample"]),
            )
    except (OSError, KeyError, ValueError) as e:
        log.warning("Failed to load checkpoint %s: %s", path, e)
        return None
