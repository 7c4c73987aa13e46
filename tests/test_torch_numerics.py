"""The port's square roots and camera tangent on the CPU are the correctly
rounded f32 results, bit for bit, whatever the host's math library.

torch's f32 `sqrt` on the CPU misses the correctly rounded result by an
ulp on a share of inputs that depends on the host (0.6% on one, 17.4% on
another), and its f32 `tan` is an ulp off at the default camera's 45
degrees. XLA's and numpy's are correctly rounded there, so those misses
moved the port's rays away from the JAX package's on some hosts only. Each
reference below is numpy: the same f32 operations in the same order, with
the square root and the tangent taken in f64 and rounded once to f32.
"""

import math

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.core import threefry, vec
from path_tracer_ai_tpu_torch.core.types import MATERIAL_DIELECTRIC
from path_tracer_ai_tpu_torch.engine import shading
from path_tracer_ai_tpu_torch.scene import camera

F32 = np.float32
N_VEC = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, whose torch threads would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sqrt_rn(x):
    return np.sqrt(np.asarray(x, np.float64)).astype(F32)


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _normalize(a):
    return a / _sqrt_rn(_dot(a, a))[:, None]


def _bits_equal(ours: torch.Tensor, theirs: np.ndarray) -> None:
    ours = ours.numpy()
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    differ = int((ours.view(np.int32) != theirs.view(np.int32)).sum())
    assert differ == 0, f"{differ} of {ours.size} words differ"


def _vectors(seed: int, n: int = N_VEC) -> np.ndarray:
    """Seeded vectors over eight binades of length."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    return (v * np.exp2(rng.integers(-4, 4, (n, 1)))).astype(F32)


def test_sqrt_rn_is_correctly_rounded():
    x = np.random.default_rng(0).uniform(0.0, 50.0, 1 << 20).astype(F32)
    edges = np.array([0.0, np.finfo(F32).smallest_subnormal,
                      np.finfo(F32).tiny, 1.0, 2.0, np.finfo(F32).max,
                      np.inf], F32)
    x = np.concatenate([x, edges])
    _bits_equal(vec.sqrt_rn(torch.from_numpy(x)), _sqrt_rn(x))


def test_length_and_normalize_bitwise():
    a = _vectors(1)
    t = torch.from_numpy(a)
    _bits_equal(vec.length(t), _sqrt_rn(_dot(a, a)))
    _bits_equal(vec.normalize(t), _normalize(a))
    _bits_equal(vec.safe_normalize(t), _normalize(a))


@pytest.mark.parametrize("eta", [1.0 / 1.5, 1.5, "lanes"])
def test_refract_bitwise(eta):
    incident, normal = _normalize(_vectors(3)), _normalize(_vectors(4))
    ndi = _dot(normal, incident)[:, None]
    if eta == "lanes":  # a ratio a lane, as sample_bsdf passes it
        eta_n = np.random.default_rng(2).uniform(0.5, 2.0, N_VEC).astype(F32)
        eta_t, eta_n, eta2 = torch.from_numpy(eta_n), eta_n[:, None], None
    else:  # a Python float: eta * eta is a double product, rounded once
        eta_t, eta_n, eta2 = eta, F32(eta), F32(eta * eta)
    k = 1.0 - (eta_n * eta_n if eta2 is None else eta2) * (1.0 - ndi * ndi)
    refr = eta_n * incident - (eta_n * ndi
                               + _sqrt_rn(np.maximum(k, 0.0))) * normal
    want = np.where(k < 0.0, F32(0.0), refr)
    assert (k < 0.0).any() == (eta != 1.0 / 1.5)  # total internal reflection
    _bits_equal(vec.refract(torch.from_numpy(incident),
                            torch.from_numpy(normal), eta_t), want)


def test_dielectric_direction_bitwise():
    """sample_bsdf's dielectric branch (sin_theta, the total internal
    reflection test at it, Schlick's Fresnel, reflect or refract) against
    numpy, with lanes packed near the critical angle, where an ulp of
    sin_theta flips the choice."""
    rng = np.random.default_rng(5)
    n = N_VEC
    normal = _normalize(_vectors(6, n))
    ior = rng.uniform(1.3, 1.7, n).astype(F32)
    # cos of the ray against the normal: near the critical angle of the
    # exit (sin = 1 / ior), on both sides of the surface
    crit = np.sqrt(1.0 - 1.0 / ior.astype(np.float64) ** 2)
    cos_t = (crit * (1.0 + rng.uniform(-1e-5, 1e-5, n))).astype(F32)
    side = np.where(rng.random(n) < 0.75, F32(1.0), F32(-1.0))
    tangent = _normalize(np.cross(normal, _vectors(7, n)).astype(F32))
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t.astype(np.float64) ** 2))
    ray = _normalize((-side[:, None] * cos_t[:, None] * normal
                      + sin_t.astype(F32)[:, None] * tangent).astype(F32))
    fresnel_u = rng.random(n).astype(F32)

    cos_i = _dot(-ray, normal)
    entering = cos_i >= 0.0
    n_or = np.where(entering[:, None], normal, -normal)
    cos_abs = np.abs(cos_i)
    etai = np.where(entering, F32(1.0), ior)
    etat = np.where(entering, ior, F32(1.0))
    ratio = etai / etat
    sin_theta = _sqrt_rn(np.maximum(1.0 - cos_abs * cos_abs, 0.0))
    tir = ratio * sin_theta > 1.0
    f0 = (etai - etat) / (etai + etat)
    x = 1.0 - cos_abs
    fresnel = f0 + (1.0 - f0) * ((x * x) * (x * x) * x)
    reflect = ray - 2.0 * _dot(n_or, ray)[:, None] * n_or
    ndi = _dot(n_or, ray)[:, None]
    r = ratio[:, None]
    k = 1.0 - r * r * (1.0 - ndi * ndi)
    refract = np.where(k < 0.0, F32(0.0),
                       r * ray - (r * ndi + _sqrt_rn(np.maximum(k, 0.0)))
                       * n_or)
    want = np.where((tir | (fresnel_u < fresnel))[:, None], reflect, refract)
    assert 0.05 < tir.mean() < 0.5

    mats = shading.MaterialLanes(
        mtype=torch.full((n,), MATERIAL_DIELECTRIC, dtype=torch.int32),
        albedo=torch.ones((n, 3)), roughness=torch.zeros(n),
        ior=torch.from_numpy(ior))
    out = shading.sample_bsdf(torch.from_numpy(ray), torch.zeros((n, 3)),
                              torch.from_numpy(normal), mats,
                              torch.zeros((n, 3)), torch.from_numpy(fresnel_u))
    _bits_equal(out.direction, want)


@pytest.mark.parametrize("fov", [20.0, 45.0, 60.0, 90.0, 120.0])
def test_camera_rays_bitwise(fov):
    """get_rays: tan of the f32 half angle through f64, then the viewport
    and normalize in f32."""
    cam = camera.default_camera("cpu")._replace(
        fov_deg=torch.tensor(F32(fov)))
    rng = np.random.default_rng(8)
    u, v = rng.random(4096).astype(F32), rng.random(4096).astype(F32)
    aspect = 16.0 / 9.0
    half = F32(fov) * F32(math.pi / 180.0) / F32(2.0)
    h = F32(np.tan(np.float64(half)))
    vh = F32(2.0) * h
    vw = vh * F32(aspect)
    right, up, fwd = (c.numpy() for c in (cam.right, cam.up, cam.forward))
    horizontal, vertical = vw * right, vh * up
    lower_left = -horizontal / F32(2.0) - vertical / F32(2.0) + fwd
    d = (lower_left + u[:, None] * horizontal) + v[:, None] * vertical
    _, dirs = camera.get_rays(cam, torch.from_numpy(u), torch.from_numpy(v),
                              aspect)
    _bits_equal(dirs, _normalize(d))


def test_no_f32_sqrt_or_tan_on_the_cpu(monkeypatch):
    """Every square root and tangent of the port's shared paths takes f64
    on the CPU: a render, the sphere draws and the dielectric sample call
    torch.sqrt and torch.tan with no f32 tensor."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    seen = []

    def spy(fn):
        def call(x, *args, **kw):
            seen.append((fn.__name__, x.dtype))
            return fn(x, *args, **kw)
        return call

    monkeypatch.setattr(torch, "sqrt", spy(torch.sqrt))
    monkeypatch.setattr(torch, "tan", spy(torch.tan))
    scene = blob_scene(1, device="cpu")
    settings = RenderSettings(width=8, height=6, samples_per_pixel=1,
                              max_bounces=3, seed=0)
    oracle.render(scene, camera.default_camera("cpu"), settings, device="cpu")
    wavefront.render(scene, camera.default_camera("cpu"), settings,
                     device="cpu")
    threefry.normal(threefry.key(0), (64, 3))
    v = torch.from_numpy(_vectors(9, 64))
    vec.refract(vec.normalize(v), vec.normalize(v.flip(0)), 1.5)
    assert {name for name, _ in seen} == {"sqrt", "tan"}
    f32 = {name for name, dtype in seen if dtype != torch.float64}
    assert not f32, f"torch.{f32} took a tensor other than f64"
