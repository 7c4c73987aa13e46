"""The port's threefry streams against jax.random.

Key data, fold_in chains and uniform draws must be bit-equal. normal (and
uniform_sphere built on it) goes through log1p, whose last-ulp rounding
differs between XLA's CPU code and torch: measured ~99% of draws
bit-equal, the rest within 3 ulps, which is the bound held here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.core import sampling as jsampling
from path_tracer_ai_tpu_torch.core import sampling, threefry
from path_tracer_ai_tpu_torch.convert import key_from_data

SEEDS = [0, 1, 5, 123456789, 2**31 + 7, 2**32 - 1]
NORMAL_ULPS = 3


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _kd(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed(seed):
    kj = jax.random.key(np.uint32(seed))
    np.testing.assert_array_equal(_kd(kj), threefry.key(seed).numpy())
    np.testing.assert_array_equal(
        key_from_data(np.asarray(jax.random.key_data(kj))).numpy(), _kd(kj))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_chains_and_uniform_bitwise(seed):
    rng = np.random.default_rng(seed % 1000)
    pix = rng.integers(0, 1920 * 1080, 257).astype(np.int32)
    smp = rng.integers(0, 64, 257).astype(np.int32)
    kb = jax.random.key(np.uint32(seed))
    keys_j = jax.vmap(lambda p, s: jsampling.bounce_key(
        jsampling.sample_key(kb, p, s), 0, 0))(pix, smp)
    kt = threefry.key(seed)
    keys_t = sampling.fold_all(kt, torch.as_tensor(pix), torch.as_tensor(smp),
                               0, 0)
    np.testing.assert_array_equal(_kd(keys_j), keys_t.numpy())
    # per-lane depths and every purpose tag
    depth = rng.integers(0, 16, 257).astype(np.int32)
    for tag in (0, 1, 2, 3):
        kj = jax.vmap(lambda k, d: jax.random.fold_in(
            jax.random.fold_in(k, d), tag))(keys_j, depth)
        kt2 = threefry.fold_in(threefry.fold_in(keys_t, torch.as_tensor(depth)),
                               tag)
        np.testing.assert_array_equal(_kd(kj), kt2.numpy())
        uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(kj))
        ut = threefry.uniform(kt2, (2,)).numpy()
        np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
        uj1 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k))(kj))
        np.testing.assert_array_equal(
            uj1.view(np.int32), threefry.uniform(kt2).numpy().view(np.int32))


def test_random_bits_partitionable_layout():
    kj = jax.random.key(np.uint32(42))
    bj = np.asarray(jax.random.bits(kj, (5, 7), jnp.uint32)).astype(np.int64)
    bt = threefry.random_bits(threefry.key(42), (5, 7)).numpy()
    np.testing.assert_array_equal(bj, bt)


def test_normal_within_ulps():
    kj = jax.random.key(np.uint32(3))
    nj = np.asarray(jax.random.normal(kj, (1 << 16,)))
    nt = threefry.normal(threefry.key(3), (1 << 16,)).numpy()
    ulp = _ulps(nj, nt)
    assert ulp.max() <= NORMAL_ULPS
    assert (ulp == 0).mean() > 0.95


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_sphere_within_ulps(seed):
    pix = np.arange(0, 4096 * 3, 3, dtype=np.int32)
    kb = jax.random.key(np.uint32(seed))
    kj = jax.vmap(lambda p: jax.random.fold_in(jax.random.fold_in(kb, p),
                                               jsampling.TAG_BSDF))(pix)
    sj = np.asarray(jax.vmap(jsampling.uniform_sphere)(kj))
    kt = threefry.fold_in(threefry.fold_in(threefry.key(seed),
                                           torch.as_tensor(pix)),
                          sampling.TAG_BSDF)
    st = sampling.uniform_sphere(kt).numpy()
    # normalization adds a rounding or two on top of normal's 3 ulps
    np.testing.assert_allclose(st, sj, rtol=0, atol=4e-7)
    np.testing.assert_allclose(np.linalg.norm(st, axis=1), 1.0, atol=1e-6)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = threefry.erf_inv(x).numpy()
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
