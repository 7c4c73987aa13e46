"""The port's plain paths at cluster sizes outside the kernels' tuned
instances (S = 16 and 96, the second not a power of two) against the JAX
package: the queries each backend's waves go through, and a render.

On the CPU every kernel wrapper runs its plain version, which takes any S;
on the card the same shapes go to each kernel's generic instance
(tests/test_torch_cuda.py holds those bitwise against these plain
versions). Tolerances are tests/test_torch_traversal.py's: hit, tri and
occlusion exact, t within rtol 1e-6 + atol 2e-6 (XLA's CPU code contracts
FMAs); against the port's brute force, t bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import ctiles as jctiles
from path_tracer_ai_tpu.accel import kslots as jkslots
from path_tracer_ai_tpu.accel import traverse as jtraverse
from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu_torch.accel import ctiles, kslots, traverse, worklist
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_torch_traversal import T_TOL, _setup

T = torch.as_tensor
SIZES = [16, 96]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(rng, s, n):
    ja, pa, ptris, o, d, tm = _setup(rng, 900, s, n)
    tm[1::5] = np.inf
    return ja, pa, ptris, o, d, tm


def _check_closest(ht, hj, ptris, o, d, tm):
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, T(o), T(d), 1e-3, T(tm))
    hit = bf.hit.numpy()
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(ht.hit.numpy(), hit)
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())


@pytest.mark.parametrize("s", SIZES)
def test_shadow_cascade_at_s(rng, s):
    """The main path's shadow waves (any_hit_packets: tile_sweep at T 64,
    two clusters a tile)."""
    ja, pa, ptris, o, d, tm = _rays(rng, s, 64 * 48)
    occ_t = traverse.any_hit_packets(pa, T(o), T(d), 1e-3, T(tm),
                                     block_size=64, group_size=2)
    occ_j = np.asarray(jtraverse.any_hit_packets(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm),
        block_size=64, group_size=2))
    assert 0.05 < occ_j.mean() < 0.95
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(
        occ_t.numpy(), intersect.any_hit(ptris, T(o), T(d), 1e-3,
                                         T(tm)).numpy())


@pytest.mark.parametrize("s", SIZES)
def test_ctiles_closest_at_s(rng, s):
    """ctiles' closest waves (tile_sweep at T 128), with the overflow
    fallback (cap 4)."""
    ja, pa, ptris, o, d, tm = _rays(rng, s, 1024)
    kw = dict(cap=4, tile_chunk=4, fallback_compact=1 << 12)
    ht = ctiles.closest_hit_ctiles(pa, T(o), T(d), 1e-3, T(tm), **kw)
    hj = jctiles.closest_hit_ctiles(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                    jnp.asarray(tm), fallback_sorted=True,
                                    **kw)
    _check_closest(ht, hj, ptris, o, d, tm)


@pytest.mark.parametrize("s", SIZES)
def test_worklist_closest_at_s(rng, s):
    """The worklist's closest waves (item_sweep, blocks of 8, items of 4)."""
    ja, pa, ptris, o, d, tm = _rays(rng, s, 1024)
    kw = dict(cap=256, item_budget=32)
    ht = worklist.closest_hit_worklist(pa, T(o), T(d), 1e-3, T(tm), **kw)
    hj = jworklist.closest_hit_worklist(ja, jnp.asarray(o), jnp.asarray(d),
                                        1e-3, jnp.asarray(tm), **kw)
    _check_closest(ht, hj, ptris, o, d, tm)


@pytest.mark.parametrize("s", SIZES)
def test_kslots_closest_at_s(rng, s):
    """kslots' closest waves (kslot_sweep, K 12 slots a ray)."""
    ja, pa, ptris, o, d, tm = _rays(rng, s, 1024)
    ht = kslots.closest_hit_kslots(pa, T(o), T(d), 1e-3, T(tm))
    hj = jkslots.closest_hit_kslots(ja, jnp.asarray(o), jnp.asarray(d),
                                    1e-3, jnp.asarray(tm))
    _check_closest(ht, hj, ptris, o, d, tm)


@pytest.fixture(scope="module")
def render_scene():
    """tests/test_torch_render.py's scene, camera and settings."""
    from tests.test_torch_render import both

    return both.__wrapped__()


@pytest.mark.parametrize("s", SIZES)
def test_render_at_s_matches_jax_and_oracle(render_scene, s):
    """wavefront.render on an S-wide base accel (shadow waves at S; closest
    waves on the S = 256 accel it builds): the JAX render at RMSE_REL and
    the port's oracle bitwise."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
    from path_tracer_ai_tpu.config import RenderSettings as JSettings
    from path_tracer_ai_tpu.engine import wavefront as jwavefront
    from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.convert import accel_from_numpy
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from tests.test_torch_render import RMSE_REL, _settings

    b = render_scene
    t = b["jscene"].triangles
    ja = jbuild(SimpleNamespace(v0=np.asarray(t.v0), v1=np.asarray(t.v1),
                                v2=np.asarray(t.v2)), cluster_size=s)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    img = wavefront.render(b["scene"], b["camera"], _settings(RenderSettings),
                           accel=pa, wave_size=1 << 11, device="cpu")
    ref = np.asarray(jwavefront.render(b["jscene"], jcamera(),
                                       _settings(JSettings), accel=ja,
                                       wave_size=1 << 11, block_size=64))
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse <= RMSE_REL * float(ref.mean()), (rmse, float(ref.mean()))
    np.testing.assert_array_equal(
        img, oracle.render(b["scene"], b["camera"], _settings(RenderSettings),
                           device="cpu"))
