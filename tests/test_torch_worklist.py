"""The port's accel.worklist (flat cull, fallback routes) against the JAX
package's and brute force.

Same inputs (numpy, seeded) through `path_tracer_ai_tpu.accel.worklist` and
`path_tracer_ai_tpu_torch.accel.worklist` on the CPU, where the item sweep
is item_sweep's plain version. hit, tri and occlusion must match exactly;
t within rtol 1e-6 plus atol 2e-6 (XLA's CPU code contracts FMAs, eager
torch does not; ROADMAP §3). Against the port's own brute force, t is
bitwise. The sort modes and the fallback routes are in
tests/test_torch_worklist_routes.py; the 2-level cull, the WorkList tables
and the item sweep in tests/test_torch_worklist_2level.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu_torch.accel import worklist
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
from tests.test_accel import random_soup

T = torch.as_tensor
T_TOL = dict(rtol=1e-6, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(rng, n_tris, s, super_size=16, spread=4.0):
    jtris = random_soup(rng, n_tris, spread=spread)
    ja = jbuild(jtris, cluster_size=s, super_size=super_size)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in jtris), device="cpu")
    return ja, pa, ptris


def _rays(rng, n, spread=4.5, t_max=(0.3, 12.0), dead_every=7):
    """Rays from inside the soup's box (most of them see triangles)."""
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = (np.full(n, np.inf, np.float32) if t_max is None
          else rng.uniform(*t_max, n).astype(np.float32))
    if dead_every:
        tm[::dead_every] = -1.0
    return o, d, tm


def _camera_rays(rng, n, dead_every=7):
    """Coherent rays: a jittered eye at z = -9 looking into the soup through
    a square cone, so that sorted blocks of 8 cull to a few clusters."""
    o = np.asarray([0.0, 0.0, -9.0]) + rng.standard_normal((n, 3)) * 0.05
    d = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, np.inf, np.float32)
    tm[::dead_every] = -1.0
    return o.astype(np.float32), d.astype(np.float32), tm


def _check(ja, pa, ptris, o, d, tm, any_hit=True, **kw):
    """Closest and any hit: exact against JAX and brute force."""
    args_j = (jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tm))
    args_t = (T(o), T(d), 1e-3, T(tm))
    hj = jworklist.closest_hit_worklist(ja, *args_j, **kw)
    ht = worklist.closest_hit_worklist(pa, *args_t, **kw)
    assert np.asarray(hj.hit).mean() > 0.03
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, *args_t)
    np.testing.assert_array_equal(ht.t.numpy(), bf.t.numpy())
    hit = bf.hit.numpy()
    np.testing.assert_array_equal(ht.tri.numpy()[hit], bf.tri.numpy()[hit])
    if not any_hit:
        return
    occ_j = np.asarray(jworklist.any_hit_worklist(ja, *args_j, **kw))
    occ_t = worklist.any_hit_worklist(pa, *args_t, **kw)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(occ_t.numpy(),
                                  intersect.any_hit(ptris, *args_t).numpy())


LEVELS = {"flat": dict(levels=1), "2level": dict(levels=2, super_cap=None)}


def _levels_kw(name, ja):
    kw = dict(LEVELS[name])
    if "super_cap" in kw:
        kw["super_cap"] = ja.num_supers
    return kw


# (soup triangles, cluster size, rays, options)
CASES = {
    "plain": (500, 16, 320, {}),
    "small_blocks": (300, 8, 200, dict(block=4, group=2, item_chunk=8,
                                       row_chunk=16)),
    "cap_overflow": (400, 8, 256, dict(cap=6)),
    "budget_overflow": (600, 8, 256, dict(item_budget=1, item_chunk=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_worklist_matches_jax(rng, case, levels="flat"):
    n_tris, s, n, kw = CASES[case]
    ja, pa, ptris = _scene(rng, n_tris, s, super_size=4)
    o, d, tm = _rays(rng, n)
    _check(ja, pa, ptris, o, d, tm, **kw, **_levels_kw(levels, ja))


@pytest.mark.parametrize("name", ["mxu:fast", "exact:mxu", "bvh"])
def test_unknown_intersector_raises(rng, name):
    """The port accepts "exact" and the "mxu" forms only; the reference
    would take any other name as exact (ROADMAP §3)."""
    ja, pa, _ = _scene(rng, 300, 16)
    o, d, tm = _rays(rng, 64)
    with pytest.raises(ValueError, match="intersector"):
        worklist.closest_hit_worklist(pa, T(o), T(d), 1e-3, T(tm),
                                      intersector=name)
