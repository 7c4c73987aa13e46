"""Core math, scene data, camera, cluster build and PNG I/O of the port
against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu.core import geometry as jgeom
from path_tracer_ai_tpu.scene import camera as jcamera
from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
from path_tracer_ai_tpu_torch.core import geometry
from path_tracer_ai_tpu_torch.io.png import read_png, write_png
from path_tracer_ai_tpu_torch.io.image import tonemap_to_u8
from path_tracer_ai_tpu_torch.scene import camera
from path_tracer_ai_tpu_torch.scene.scene import (
    blob_materials,
    blob_room_arrays,
    build_scene_from_arrays,
)

T = torch.as_tensor


def _tris(rng, t):
    v0 = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return v0, v1, v2


def test_moller_trumbore_matches_jax(rng):
    v0, v1, v2 = _tris(rng, 64)
    o = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    d = rng.standard_normal((200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.5, 20, 200).astype(np.float32)
    tmax[::9] = -1.0
    hj = jgeom.moller_trumbore(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                               jnp.asarray(v1), jnp.asarray(v2), 1e-3,
                               jnp.asarray(tmax))
    ht = geometry.moller_trumbore(T(o), T(d), T(v0), T(v1), T(v2), 1e-3, T(tmax))
    assert np.asarray(hj.valid).sum() > 0
    np.testing.assert_array_equal(ht.valid.numpy(), np.asarray(hj.valid))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)


def test_aabb_hit_nan_edge_matches_jax(rng):
    bmin = rng.uniform(-2, 0, (40, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 2, (40, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    # axis-parallel rays whose origin lies exactly on a slab plane: 0*inf NaN
    d[:16, 1:] = 0.0
    o[:16, 1] = bmin[0, 1]
    o[16:24, 2] = bmax[3, 2]
    d[16:24, 2] = 0.0
    hj, lj = jgeom.aabb_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bmin),
                            jnp.asarray(bmax), 1e-3, 50.0)
    ht, lt = geometry.aabb_hit(T(o), T(d), T(bmin), T(bmax), 1e-3, 50.0)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert ht[:24].any()


def test_blob_scene_arrays_match_jax():
    from __graft_entry__ import _demo_scene

    jscene, jaccel = _demo_scene(subdivisions=2)
    scene = build_scene_from_arrays(*blob_room_arrays(2),
                                    materials=blob_materials(), device="cpu")
    for a, b in zip(scene.triangles, jscene.triangles):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(scene.materials, jscene.materials):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(scene.lights, jscene.lights):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    accel = build_clusters(scene.triangles, cluster_size=128)
    for a, b in zip(accel, jaccel):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cluster_size", [128, 256])
def test_build_clusters_matches_jax(cluster_size):
    from types import SimpleNamespace

    arr = blob_room_arrays(4)
    ja = jbuild(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                cluster_size=cluster_size)
    pa = build_clusters(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                        cluster_size=cluster_size, device="cpu")
    assert pa.num_clusters == ja.num_clusters > 10
    for name, a, b in zip(pa._fields, pa, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_morton3d_np_and_native_order_match_jax(rng):
    """morton3d_np (10 bits an axis) and native_morton_order bitwise
    against JAX's; without the native library the stable argsort of the
    codes gives the same order."""
    from path_tracer_ai_tpu.accel import morton as jmorton
    from path_tracer_ai_tpu.accel import native as jnative
    from path_tracer_ai_tpu_torch.accel import morton, native

    v0, v1, v2 = _tris(rng, 3000)
    pts = (v0 + v1 + v2) / 3.0
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    codes = morton.morton3d_np(pts, lo, hi)
    assert codes.dtype == np.uint32
    np.testing.assert_array_equal(codes, jmorton.morton3d_np(pts, lo, hi))
    np.testing.assert_array_equal(morton.morton3d_np(pts, lo, hi, bits=6),
                                  jmorton.morton3d_np(pts, lo, hi, bits=6))
    order = native.native_morton_order(v0, v1, v2)
    assert order is not None  # native/libptnative.so loads (built if absent)
    np.testing.assert_array_equal(order, jnative.native_morton_order(v0, v1,
                                                                     v2))
    np.testing.assert_array_equal(order, np.argsort(codes, kind="stable"))


@pytest.mark.parametrize("native_lib", [True, False])
def test_build_clusters_morton_matches_jax(native_lib, monkeypatch):
    """method="morton": every array equals JAX's build_clusters(method=
    "morton"), through the native order and through the numpy fallback;
    and it differs from the split build."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel import native

    arr = blob_room_arrays(3)
    tris = SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2])
    ja = jbuild(tris, cluster_size=64, method="morton")
    if not native_lib:
        monkeypatch.setattr(native, "native_morton_order",
                            lambda *a: None)
    pa = build_clusters(tris, cluster_size=64, method="morton", device="cpu")
    for name, a, b in zip(pa._fields, pa, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    split = build_clusters(tris, cluster_size=64, device="cpu")
    assert not np.array_equal(split.tri_id.numpy(), pa.tri_id.numpy())


def test_get_rays_matches_jax(rng):
    u = rng.uniform(0, 1, 500).astype(np.float32)
    v = rng.uniform(0, 1, 500).astype(np.float32)
    for aspect in (16.0 / 9.0, 1.3):
        oj, dj = jcamera.get_rays(jcamera.default_camera(), jnp.asarray(u),
                                  jnp.asarray(v), aspect)
        ot, dt = camera.get_rays(camera.default_camera(device="cpu"), T(u), T(v), aspect)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                                   atol=1e-7)
    jc = jcamera.default_camera()
    for a, b in zip(camera.default_camera(device="cpu"), jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_triangle_bounds_and_centers_match_jax(rng):
    v0, v1, v2 = _tris(rng, 200)
    jmin, jmax = jgeom.triangle_aabbs(*(jnp.asarray(v) for v in (v0, v1, v2)))
    tmin, tmax = geometry.triangle_aabbs(T(v0), T(v1), T(v2))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    np.testing.assert_allclose(
        geometry.triangle_centers(T(v0), T(v1), T(v2)).numpy(),
        np.asarray(jgeom.triangle_centers(*(jnp.asarray(v)
                                            for v in (v0, v1, v2)))),
        rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("width,height", [(1920, 1080), (7, 3)])
def test_pixel_uv_matches_jax(width, height):
    """The reference divides by (dim - 1): the last pixel maps to 1."""
    x = np.arange(width, dtype=np.float32)[::max(1, width // 64)]
    y = np.arange(height, dtype=np.float32)[::max(1, height // 64)]
    xs, ys = np.meshgrid(x, y)
    uj, vj = jcamera.pixel_uv(jnp.asarray(xs), jnp.asarray(ys), width, height)
    ut, vt = camera.pixel_uv(T(xs), T(ys), width, height)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    last = camera.pixel_uv(T([width - 1.0]), T([height - 1.0]), width, height)
    assert [float(a) for a in last] == [1.0, 1.0]


def test_png_round_trip(tmp_path, rng):
    img = rng.uniform(0, 1.5, (9, 13, 3)).astype(np.float32)
    u8 = tonemap_to_u8(img, 2.2)
    path = str(tmp_path / "x.png")
    write_png(path, u8)
    np.testing.assert_array_equal(read_png(path), u8)


def _first_tensor(x):
    while not torch.is_tensor(x):
        x = x[0]
    return x


@pytest.mark.parametrize("name", ["build_scene_from_arrays",
                                  "pack_materials", "default_lights",
                                  "blob_scene"])
def test_scene_entry_points_default_to_the_card(name):
    """device=None means the card: without one these raise, as every entry
    point of the port does; the CPU runs only when asked for."""
    from path_tracer_ai_tpu_torch.scene import scene as sc

    call = {
        "build_scene_from_arrays": lambda **kw: sc.build_scene_from_arrays(
            *blob_room_arrays(1), **kw),
        "pack_materials": lambda **kw: sc.pack_materials(blob_materials(),
                                                         **kw),
        "default_lights": sc.default_lights,
        "blob_scene": lambda **kw: sc.blob_scene(1, **kw),
    }[name]
    assert _first_tensor(call(device="cpu")).device.type == "cpu"
    if torch.cuda.is_available():
        assert _first_tensor(call()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
