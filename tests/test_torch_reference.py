"""The reference renders of tests/data/jax_reference.npz
(scripts/torch_make_reference.py): the JAX package reproduces its own
stored oracle image, the port on the CPU reproduces its stored images bit
for bit, and the port's images lie within RMSE 1e-3 x the mean of JAX's
(the bound of test_torch_render.py). chip_smoke.py's `reference` phase
holds the card's images against the same file.

Both packages render the scene and camera arrays as stored, so the host's
numpy (which builds the blob) does not enter. JAX's stored image is taken
to be the same bits on every x86-64 host with FMA (XLA's CPU code uses its
own polynomials, not the host's math library); a new JAX version may move
it, and then scripts/torch_make_reference.py rewrites the file.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.config import RenderSettings as JSettings
from path_tracer_ai_tpu.core.types import Lights as JLights
from path_tracer_ai_tpu.core.types import MaterialTable as JMaterials
from path_tracer_ai_tpu.core.types import SceneData as JScene
from path_tracer_ai_tpu.core.types import TrianglesSoA as JTriangles
from path_tracer_ai_tpu.engine import oracle as joracle
from path_tracer_ai_tpu.scene.camera import Camera as JCamera
from path_tracer_ai_tpu_torch.convert import REFERENCE_PARTS, load_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "data", "jax_reference.npz")
RMSE_REL = 1e-3
RR_STARTS = (0, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, whose torch threads would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return load_reference(PATH, device="cpu")


@pytest.fixture(scope="module")
def port_images(ref):
    """The port's renders on the CPU, by the stored images' names, as the
    script that wrote the file made them."""
    spec = importlib.util.spec_from_file_location(
        "torch_make_reference",
        os.path.join(ROOT, "scripts", "torch_make_reference.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.port_renders(ref)


def _rmse_ratio(img, ref_img) -> float:
    return float(np.sqrt(np.mean((img - ref_img) ** 2)) / ref_img.mean())


def test_file_holds_the_stated_settings(ref):
    assert sorted(ref.settings) == list(RR_STARTS)
    for rr, s in ref.settings.items():
        assert (s.width, s.height, s.samples_per_pixel, s.max_bounces,
                s.seed, s.rr_start) == (48, 27, 2, 5, 0, rr)
    assert ref.subdivisions == 3
    assert ref.scene.triangles.count == 20 * 4 ** 3 + 8  # blob + room
    names = {f"{who}_{eng}_rr{rr}" for rr in RR_STARTS
             for who, eng in (("jax", "oracle"), ("jax", "wavefront"),
                              ("port", "oracle"), ("port", "main"))}
    assert set(ref.images) == names
    for img in ref.images.values():
        assert img.shape == (27, 48, 3) and img.dtype == np.float32
        assert np.isfinite(img).all() and (img.max(-1) > 0).mean() > 0.5
    assert os.path.getsize(PATH) < 200_000


@pytest.mark.parametrize("rr", RR_STARTS)
def test_jax_oracle_reproduces_the_stored_image(ref, rr):
    """The file is not stale: JAX's oracle on the stored arrays gives the
    stored image, bit for bit."""
    with np.load(PATH) as z:
        part = {p: [jnp.asarray(z[f"{p}_{n}"]) for n in names]
                for p, names in REFERENCE_PARTS.items()}
    scene = JScene(JTriangles(*part["tri"]), JMaterials(*part["mat"]),
                   JLights(*part["light"]))
    s = ref.settings[rr]
    img = np.asarray(joracle.render(scene, JCamera(*part["cam"]), JSettings(
        width=s.width, height=s.height, samples_per_pixel=s.samples_per_pixel,
        max_bounces=s.max_bounces, seed=s.seed, rr_start=rr)))
    np.testing.assert_array_equal(img, ref.images[f"jax_oracle_rr{rr}"])


@pytest.mark.parametrize("name", [f"port_{eng}_rr{rr}" for rr in RR_STARTS
                                  for eng in ("oracle", "main")])
def test_port_reproduces_its_stored_image(ref, port_images, name):
    """The port's CPU images are the same bits on every host (its square
    roots and tangent are correctly rounded)."""
    np.testing.assert_array_equal(port_images[name], ref.images[name])


@pytest.mark.parametrize("rr", RR_STARTS)
def test_port_within_rmse_of_jax(ref, port_images, rr):
    jax_oracle = ref.images[f"jax_oracle_rr{rr}"]
    ratios = {name: _rmse_ratio(port_images[f"port_{name}_rr{rr}"],
                                jax_oracle) for name in ("oracle", "main")}
    ratios["jax_wavefront"] = _rmse_ratio(ref.images[f"jax_wavefront_rr{rr}"],
                                          jax_oracle)
    print(f"rr_start={rr}: RMSE / mean against JAX's oracle image: {ratios}")
    assert max(ratios.values()) <= RMSE_REL, ratios
