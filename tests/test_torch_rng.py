"""The port's threefry streams against jax.random.

Key data, fold_in chains, uniform and normal draws must be bit-equal;
normal needs threefry.log1p_xla, XLA's own f32 log1p. Every f32 in (-1, 0],
the domain erf_inv gives it, against jnp.log1p (about four minutes on a
CPU; the tests below take a stride of it):
    JAX_PLATFORMS=cpu python -m tests.test_torch_rng
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
LOG1P_BITS = (0x80000000, 0xBF800000)  # -0.0 up to -(1 - 2^-24), as uint32


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
        key_from_data(np.asarray(jax.random.key_data(kj)), device="cpu").numpy(), _kd(kj))


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
    """Bit-equal, 0 ulps, on every draw."""
    kj = jax.random.key(np.uint32(3))
    nj = np.asarray(jax.random.normal(kj, (1 << 16,)))
    nt = threefry.normal(threefry.key(3), (1 << 16,)).numpy()
    assert _ulps(nj, nt).max() == 0


def log1p_mismatches(stride: int = 1, chunk: int = 1 << 24) -> int:
    """How many f32 of every `stride`-th bit pattern in (-1, 0] log1p_xla
    maps to other bits than jnp.log1p does."""
    jlog1p = jax.jit(jnp.log1p)
    bad = 0
    lo, hi = LOG1P_BITS
    for start in range(lo, hi, chunk * stride):
        bits = np.arange(start, min(start + chunk * stride, hi), stride,
                         dtype=np.uint64).astype(np.uint32)
        x = bits.view(np.float32)
        ref = np.asarray(jlog1p(x)).view(np.int32)
        bad += int((threefry.log1p_xla(torch.from_numpy(x)).numpy()
                    .view(np.int32) != ref).sum())
    return bad


@pytest.mark.parametrize("stride", [4099, 65537])
def test_log1p_xla_bitwise_on_erf_inv_domain(stride):
    """A stride of the f32 in (-1, 0] (denormals, -0.0 and the branch
    boundary near 1 - sqrt(2) included); the whole domain is the module's
    main."""
    assert log1p_mismatches(stride) == 0
    edges = torch.tensor([0.0, -0.0, -1e-40, -1.17549435e-38, -0.41421354,
                          -0.41421357, -0.4142136, -0.5, -0.99999994,
                          -1e-20, -2.0 ** -24])
    ref = np.asarray(jnp.log1p(edges.numpy())).view(np.int32)
    np.testing.assert_array_equal(
        threefry.log1p_xla(edges).numpy().view(np.int32), ref)


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
    # bit-equal: the normals are, and eager JAX runs each op of the
    # normalization alone (no FMA), with a correctly rounded sqrt as the
    # port's (vec.sqrt_rn); atol 4e-7 absorbed torch's CPU sqrt before
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
    np.testing.assert_allclose(np.linalg.norm(st, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_sample_and_bounce_keys_bitwise(seed):
    """sample_key and bounce_key: the reference's fold_in chains, key data
    bit for bit, with Python ints and per-lane tensors."""
    rng = np.random.default_rng(seed % 1000)
    pix = rng.integers(0, 1920 * 1080, 129).astype(np.int32)
    smp = rng.integers(0, 64, 129).astype(np.int32)
    depth = rng.integers(0, 16, 129).astype(np.int32)
    kb = jax.random.key(np.uint32(seed))
    kj = jax.vmap(lambda p, s, dd: jsampling.bounce_key(
        jsampling.sample_key(kb, p, s), dd, jsampling.TAG_FRESNEL))(
            pix, smp, depth)
    kt = sampling.bounce_key(
        sampling.sample_key(threefry.key(seed), torch.as_tensor(pix),
                            torch.as_tensor(smp)),
        torch.as_tensor(depth), sampling.TAG_FRESNEL)
    np.testing.assert_array_equal(_kd(kj), kt.numpy())
    one_j = jsampling.bounce_key(jsampling.sample_key(kb, 5, 3), 2, 1)
    one_t = sampling.bounce_key(sampling.sample_key(threefry.key(seed), 5, 3),
                                2, 1)
    np.testing.assert_array_equal(_kd(one_j), one_t.numpy())


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_hemisphere_matches_jax(seed):
    """One draw a key: the sphere sample (bit-equal, as uniform_sphere's)
    with JAX's flip into the normal's hemisphere; dot == 0 keeps the
    sample."""
    rng = np.random.default_rng(seed)
    n = 4096
    normal = rng.standard_normal((n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    kb = jax.random.key(np.uint32(seed))
    pix = np.arange(n, dtype=np.int32)
    kj = jax.vmap(lambda p: jax.random.fold_in(kb, p))(pix)
    hj = np.asarray(jax.vmap(jsampling.uniform_hemisphere)(kj,
                                                           jnp.asarray(normal)))
    kt = threefry.fold_in(threefry.key(seed), torch.as_tensor(pix))
    ht = sampling.uniform_hemisphere(kt, torch.as_tensor(normal)).numpy()
    np.testing.assert_array_equal(ht.view(np.int32), hj.view(np.int32))
    assert ((ht * normal).sum(axis=1) >= 0).all()
    # a normal orthogonal to the sample: dot == 0 is not flipped
    d = sampling.uniform_sphere(kt[:8])
    ortho = torch.stack([d[:, 1], -d[:, 0], torch.zeros(8)], dim=1)
    assert (d[:, 0] * ortho[:, 0] + d[:, 1] * ortho[:, 1] == 0).all()
    np.testing.assert_array_equal(
        sampling.uniform_hemisphere(kt[:8], ortho).numpy(), d.numpy())


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = threefry.erf_inv(x).numpy()
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0


if __name__ == "__main__":
    n = log1p_mismatches()
    print(f"log1p_xla vs jnp.log1p over the {LOG1P_BITS[1] - LOG1P_BITS[0]} "
          f"f32 in (-1, 0]: {n} mismatches")
    raise SystemExit(n != 0)
