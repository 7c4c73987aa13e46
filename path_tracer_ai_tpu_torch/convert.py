"""Carries the JAX package's state across as numpy arrays.

With these, a test runs both packages on the same scene, accel, camera and
key bits. Every function takes plain numpy arrays (`np.asarray` of the
JAX arrays), never JAX objects, so this module imports no JAX. Like every
entry point of the port they put the tensors on the card unless the caller
names another device (`device="cpu"`, as the CPU tests do).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core.types import (
    Lights,
    MaterialTable,
    SceneData,
    TrianglesSoA,
    triangles_from_numpy,
)
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.scene.camera import Camera

# The arrays of a scene and a camera in a reference file, by key prefix:
# the fields of the port's NamedTuples, which are the JAX package's.
REFERENCE_PARTS = {"tri": TrianglesSoA._fields, "mat": MaterialTable._fields,
                   "light": Lights._fields, "cam": Camera._fields}


def _t(a, device, dtype=None):
    # np.array copies: views of JAX buffers are read-only
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def scene_from_numpy(triangles, materials, lights, device=None) -> SceneData:
    """triangles: the 10 arrays of a TrianglesSoA (v0 v1 v2 n0 n1 n2 uv0
    uv1 uv2 mat_id); materials: (mtype, albedo, roughness, metallic, ior);
    lights: (position, color, intensity)."""
    device = resolve_device(device)
    return SceneData(
        triangles=triangles_from_numpy(*triangles, device=device),
        materials=MaterialTable(
            mtype=_t(materials[0], device, np.int32),
            albedo=_t(materials[1], device, np.float32),
            roughness=_t(materials[2], device, np.float32),
            metallic=_t(materials[3], device, np.float32),
            ior=_t(materials[4], device, np.float32),
        ),
        lights=Lights(*(_t(a, device, np.float32) for a in lights)),
    )


def accel_from_numpy(bmin, bmax, v0, e1, e2, tri_id, scene_min, scene_max,
                     sbmin, sbmax, cbmin, cbmax, device=None) -> ClusterAccel:
    device = resolve_device(device)
    f = lambda a: _t(a, device, np.float32)
    return ClusterAccel(
        bmin=f(bmin), bmax=f(bmax), v0=f(v0), e1=f(e1), e2=f(e2),
        tri_id=_t(tri_id, device, np.int32),
        scene_min=f(scene_min), scene_max=f(scene_max),
        sbmin=f(sbmin), sbmax=f(sbmax), cbmin=f(cbmin), cbmax=f(cbmax),
    )


def _same_bits(name, ours: torch.Tensor, theirs) -> None:
    theirs = np.asarray(theirs)
    ours = ours.cpu().numpy()
    if ours.shape != theirs.shape or ours.dtype != theirs.dtype:
        raise ValueError(f"{name}: {ours.dtype}{ours.shape} here, "
                         f"{theirs.dtype}{theirs.shape} there")
    view = np.int32 if ours.dtype.itemsize == 4 else np.uint8
    diff = int((ours.view(view) != theirs.view(view)).sum())
    if diff:
        raise ValueError(f"{name}: {diff} words differ")


def check_packs_match(accel: ClusterAccel, slab=None, pack16=None,
                      pack_dummy=None) -> None:
    """Hold the port's kernel packs of a converted accel against the JAX
    package's, bit for bit; raises ValueError on the first that differs.

    slab: (tri [C,9,S], tri_id [C,S]) of pallas_sweep.build_slab_table;
    pack16: pallas_ctiles.pack_tris [C,16,S]; pack_dummy:
    pallas_anyhit.pack_tris_dummy [C+1,16,S]; each as numpy arrays, each
    optional."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_ctiles,
        cuda_sweep,
    )

    if slab is not None:
        ours = cuda_sweep.build_slab_table(accel)
        _same_bits("slab.tri", ours.tri, slab[0])
        _same_bits("slab.tri_id", ours.tri_id, slab[1])
    if pack16 is not None:
        _same_bits("pack_tris16", cuda_ctiles.pack_tris16(accel), pack16)
    if pack_dummy is not None:
        _same_bits("pack_tris_dummy", cuda_anyhit.pack_tris_dummy(accel),
                   pack_dummy)


def camera_from_numpy(position, forward, right, up, fov_deg,
                      device=None) -> Camera:
    device = resolve_device(device)
    f = lambda a: _t(a, device, np.float32)
    return Camera(position=f(position), forward=f(forward), right=f(right),
                  up=f(up), fov_deg=f(fov_deg))


def key_from_data(data, device=None) -> torch.Tensor:
    """uint32[2] key data (jax.random.key_data) -> the port's int64 key."""
    return torch.as_tensor(np.asarray(data, np.uint32).astype(np.int64),
                           device=resolve_device(device))


def reference_arrays(triangles, materials, lights, camera) -> dict:
    """The npz entries of a scene and camera (each given as its arrays in
    field order): "tri_v0", ..., "cam_fov_deg"."""
    parts = dict(tri=triangles, mat=materials, light=lights, cam=camera)
    return {f"{p}_{name}": np.asarray(a)
            for p, arrays in parts.items()
            for name, a in zip(REFERENCE_PARTS[p], arrays, strict=True)}


def load_reference(path, device=None) -> SimpleNamespace:
    """A reference file (`scripts/torch_make_reference.py` writes it): the
    scene and camera the JAX package rendered, as the port's, on `device`
    (None: the card); `settings`, one RenderSettings a roulette start
    (`rr_starts`); `images`, every stored image by name ("jax_oracle_rr0",
    "port_main_rr2", ...); and `jax_version`."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    arrays = {p: [data[f"{p}_{n}"] for n in names]
              for p, names in REFERENCE_PARTS.items()}
    settings = {int(rr): RenderSettings(
        width=int(data["width"]), height=int(data["height"]),
        samples_per_pixel=int(data["spp"]),
        max_bounces=int(data["bounces"]), seed=int(data["seed"]),
        rr_start=int(rr)) for rr in data["rr_starts"]}
    return SimpleNamespace(
        scene=scene_from_numpy(arrays["tri"], arrays["mat"], arrays["light"],
                               device=device),
        camera=camera_from_numpy(*arrays["cam"], device=device),
        settings=settings, subdivisions=int(data["subdivisions"]),
        images={k.removeprefix("image_"): v for k, v in data.items()
                if k.startswith("image_")},
        jax_version=str(data["jax_version"]))
