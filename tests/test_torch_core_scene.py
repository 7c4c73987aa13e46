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
                                    materials=blob_materials())
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
                        cluster_size=cluster_size)
    assert pa.num_clusters == ja.num_clusters > 10
    for name, a, b in zip(pa._fields, pa, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_get_rays_matches_jax(rng):
    u = rng.uniform(0, 1, 500).astype(np.float32)
    v = rng.uniform(0, 1, 500).astype(np.float32)
    for aspect in (16.0 / 9.0, 1.3):
        oj, dj = jcamera.get_rays(jcamera.default_camera(), jnp.asarray(u),
                                  jnp.asarray(v), aspect)
        ot, dt = camera.get_rays(camera.default_camera(), T(u), T(v), aspect)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                                   atol=1e-7)
    jc = jcamera.default_camera()
    for a, b in zip(camera.default_camera(), jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_png_round_trip(tmp_path, rng):
    img = rng.uniform(0, 1.5, (9, 13, 3)).astype(np.float32)
    u8 = tonemap_to_u8(img, 2.2)
    path = str(tmp_path / "x.png")
    write_png(path, u8)
    np.testing.assert_array_equal(read_png(path), u8)
