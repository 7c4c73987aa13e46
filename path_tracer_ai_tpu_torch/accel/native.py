"""ctypes bindings to the native C++ host code (native/ptnative.cpp): the
cluster split and Morton orders and the OBJ parser.

The port's own loader for the shared library at the repository's
`native/` directory (outside both packages). If the library is absent it
is built once with `make -C native`; if that fails, callers use the numpy
median split or Morton sort and the Python OBJ parser, which give the same
results.
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
            log.info("native build unavailable (%s); using Python fallbacks",
                     e)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log.info("native library load failed (%s); using Python fallbacks",
                 e)
        return None
    lib.pt_morton_order.restype = ctypes.c_int
    lib.pt_morton_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pt_split_order.restype = ctypes.c_int
    lib.pt_split_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pt_obj_parse.restype = ctypes.c_int
    lib.pt_obj_parse.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_void_p)]
    lib.pt_obj_counts.restype = None
    lib.pt_obj_counts.argtypes = [ctypes.c_void_p, i64p, i64p, i64p, i64p,
                                  i64p, i32p, i64p, i32p]
    lib.pt_obj_read.restype = None
    lib.pt_obj_read.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, i32p,
                                i32p, i32p, i32p, ctypes.c_char_p,
                                ctypes.c_char_p]
    lib.pt_obj_free.restype = None
    lib.pt_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library loads (building it once if absent)."""
    return _load() is not None


def native_morton_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Morton-sorted triangle order via C++ (the centroids' 30-bit codes of
    morton.morton3d_np, stably sorted); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = v0.shape[0]
    inter = np.empty((t, 3, 3), np.float32)
    inter[:, 0] = v0
    inter[:, 1] = v1
    inter[:, 2] = v2
    inter = np.ascontiguousarray(inter)
    order = np.empty(t, np.int32)
    rc = lib.pt_morton_order(
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(t),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return None if rc != 0 else order


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


def native_load_obj(path: str):
    """Parse an OBJ's geometry in C++ -> objloader.ObjData (parser
    "native"), or None if the library is unavailable. Raises OSError when
    the file cannot be read.

    The MTL files are parsed in Python (they are small): the native side
    returns the mtllib names and per-face usemtl slots, which are remapped
    to MTL-file material order, as objloader._load_obj_py orders them."""
    from path_tracer_ai_tpu_torch.scene.objloader import ObjData, parse_mtl

    lib = _load()
    if lib is None:
        return None

    handle = ctypes.c_void_p()
    rc = lib.pt_obj_parse(path.encode(), ctypes.byref(handle))
    if rc != 0:
        raise OSError(f"native OBJ parse failed ({rc}): {path}")
    try:
        nv, nn, nt, nf, ub, mb = (ctypes.c_int64() for _ in range(6))
        nu, nm = ctypes.c_int32(), ctypes.c_int32()
        lib.pt_obj_counts(handle, ctypes.byref(nv), ctypes.byref(nn),
                          ctypes.byref(nt), ctypes.byref(nf),
                          ctypes.byref(ub), ctypes.byref(nu),
                          ctypes.byref(mb), ctypes.byref(nm))

        vertices = np.empty((nv.value, 3), np.float32)
        normals = np.empty((nn.value, 3), np.float32)
        texcoords = np.empty((nt.value, 2), np.float32)
        v_idx = np.empty((nf.value, 3), np.int32)
        n_idx = np.empty((nf.value, 3), np.int32)
        t_idx = np.empty((nf.value, 3), np.int32)
        slot_ids = np.empty((nf.value,), np.int32)
        usemtl_buf = ctypes.create_string_buffer(max(ub.value, 1))
        mtllib_buf = ctypes.create_string_buffer(max(mb.value, 1))

        as_f = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        as_i = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        lib.pt_obj_read(handle, as_f(vertices), as_f(normals), as_f(texcoords),
                        as_i(v_idx), as_i(n_idx), as_i(t_idx), as_i(slot_ids),
                        usemtl_buf, mtllib_buf)
    finally:
        lib.pt_obj_free(handle)

    usemtl_names = (
        usemtl_buf.raw[: ub.value].split(b"\0")[: nu.value] if ub.value else []
    )
    mtllib_names = (
        mtllib_buf.raw[: mb.value].split(b"\0")[: nm.value] if mb.value else []
    )

    # MTL files in declaration order (objloader's mtllib semantics).
    base_dir = os.path.dirname(os.path.abspath(path))
    materials = []
    mat_lookup = {}
    for name in mtllib_names:
        mtl_path = os.path.join(base_dir, name.decode(errors="replace"))
        if not os.path.exists(mtl_path):
            continue
        for m in parse_mtl(mtl_path):
            mat_lookup[m.name] = len(materials)
            materials.append(m)

    # Native usemtl slots -> MTL-file order (-1 if unknown).
    slot_to_mtl = np.asarray(
        [mat_lookup.get(n.decode(errors="replace"), -1) for n in usemtl_names]
        or [-1],
        np.int32,
    )
    mat_ids = np.where(slot_ids >= 0, slot_to_mtl[np.maximum(slot_ids, 0)], -1)

    return ObjData(
        vertices=vertices, normals=normals, texcoords=texcoords,
        v_idx=v_idx, n_idx=n_idx, t_idx=t_idx,
        mat_ids=mat_ids.astype(np.int32), materials=materials,
        parser="native",
    )
