"""The Cornell reference frame, tests/data/jax_reference_cornell.npz
(scripts/torch_make_reference.py --frame cornell): the JAX package's
`cornell` benchmark configuration's scene and camera (a box of
axis-aligned quads, two white boxes, one point light), 48x27, 2 spp, 5
bounces, seed 0. The JAX package reproduces its stored oracle image, the
port on the CPU reproduces its stored images bit for bit, and the port's
images lie within RMSE 1e-3 x the mean of JAX's oracle image.
chip_smoke.py's `reference` phase holds every route on the card against
the same file.
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
PATH = os.path.join(ROOT, "tests", "data", "jax_reference_cornell.npz")
RMSE_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return load_reference(PATH, device="cpu")


@pytest.fixture(scope="module")
def port_images(ref):
    """The port's renders on the CPU, as the script that wrote the file
    made them."""
    spec = importlib.util.spec_from_file_location(
        "torch_make_reference",
        os.path.join(ROOT, "scripts", "torch_make_reference.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.port_renders(ref)


def test_file_holds_the_cornell_box(ref):
    assert list(ref.settings) == [0]
    s = ref.settings[0]
    assert (s.width, s.height, s.samples_per_pixel, s.max_bounces,
            s.seed) == (48, 27, 2, 5, 0)
    assert ref.subdivisions == 0
    # five walls and two boxes of six faces, two triangles a quad
    assert ref.scene.triangles.count == 2 * (5 + 12)
    v = torch.stack([ref.scene.triangles.v0, ref.scene.triangles.v1,
                     ref.scene.triangles.v2], dim=1)
    # every triangle lies in a plane x, y or z = constant
    flat = (v.amax(dim=1) - v.amin(dim=1) == 0).any(dim=1)
    assert bool(flat.all())
    assert set(ref.images) == {"jax_oracle_rr0", "jax_wavefront_rr0",
                               "port_oracle_rr0", "port_main_rr0"}
    for img in ref.images.values():
        assert img.shape == (27, 48, 3) and img.dtype == np.float32
        assert np.isfinite(img).all() and (img.max(-1) > 0).mean() > 0.5
    assert os.path.getsize(PATH) < 100_000


def test_jax_oracle_reproduces_the_stored_image(ref):
    """The file is not stale: JAX's oracle on the stored arrays gives the
    stored image, bit for bit."""
    with np.load(PATH) as z:
        part = {p: [jnp.asarray(z[f"{p}_{n}"]) for n in names]
                for p, names in REFERENCE_PARTS.items()}
    scene = JScene(JTriangles(*part["tri"]), JMaterials(*part["mat"]),
                   JLights(*part["light"]))
    s = ref.settings[0]
    img = np.asarray(joracle.render(scene, JCamera(*part["cam"]), JSettings(
        width=s.width, height=s.height, samples_per_pixel=s.samples_per_pixel,
        max_bounces=s.max_bounces, seed=s.seed, rr_start=0)))
    np.testing.assert_array_equal(img, ref.images["jax_oracle_rr0"])


@pytest.mark.parametrize("name", ["port_oracle_rr0", "port_main_rr0"])
def test_port_reproduces_its_stored_image(ref, port_images, name):
    np.testing.assert_array_equal(port_images[name], ref.images[name])


def test_port_within_rmse_of_jax(ref, port_images):
    jax_oracle = ref.images["jax_oracle_rr0"]
    ratios = {name: float(np.sqrt(np.mean((img - jax_oracle) ** 2))
                          / jax_oracle.mean())
              for name, img in (*port_images.items(),
                                ("jax_wavefront",
                                 ref.images["jax_wavefront_rr0"]))}
    print(f"RMSE / mean against JAX's oracle image: {ratios}")
    assert max(ratios.values()) <= RMSE_REL, ratios
