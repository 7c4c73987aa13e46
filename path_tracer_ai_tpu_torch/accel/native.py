"""ctypes binding to the native C++ cluster split order (native/ptnative.cpp).

The port's own loader for the shared library at the repository's
`native/` directory (outside both packages). If the library is absent it
is built once with `make -C native`; if that fails, callers use the numpy
median split.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libptnative.so")

_lib = None
_lib_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_attempted
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            log.info("native build unavailable (%s); using numpy split", e)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log.info("native library load failed (%s); using numpy split", e)
        return None
    lib.pt_split_order.restype = ctypes.c_int
    lib.pt_split_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def native_split_order(centers: np.ndarray, cluster_size: int):
    """Median-split cluster order via C++; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centers, np.float32)
    order = np.empty(c.shape[0], np.int32)
    rc = lib.pt_split_order(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(c.shape[0]), ctypes.c_int64(cluster_size),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return None if rc != 0 else order
