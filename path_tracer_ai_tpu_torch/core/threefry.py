"""Counter-based threefry2x32 streams, bit for bit those of `jax.random`.

The JAX package draws every random number from `jax.random` with the
threefry2x32 implementation and `jax_threefry_partitionable=True`. This
module computes the same functions with integer torch ops, so a same-seed
render draws the same bits on both sides:

- `key(seed)`          = jax.random.key(np.uint32(seed))  -> words [0, seed]
- `fold_in(key, data)` = threefry2x32(key, (0, uint32(data)))
- `random_bits`        = y0 ^ y1 of threefry2x32(key, (hi(i), lo(i))) over
                         the flat index i of the output (partitionable
                         layout; hi(i) is 0 below 2^32 draws)
- `uniform`            = the mantissa trick: (bits >> 9) | 0x3F800000 as
                         f32, minus 1, then `max(minval, f*(max-min)+min)`
- `normal`             = sqrt(2) * erf_inv(u) with u uniform over
                         [nextafter(-1, 0), 1), and erf_inv the f32
                         polynomial that XLA's chlo.erf_inv decomposes into.

Torch has no full uint32 arithmetic (its int32 `>>` is arithmetic), so
words are held in int64 tensors masked to 32 bits. A key is an int64
tensor [..., 2]; leading dims batch independent streams.

Key data and `uniform` are bit-equal to JAX. `normal` goes through log1p,
whose last-ulp rounding differs between XLA's CPU code and torch's: about
99% of draws are bit-equal and the rest within 3 ulps
(tests/test_torch_rng.py holds that bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) on int64 tensors of uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """jax.random.key(np.uint32(seed)) as key data [2] int64."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in over a batch of keys [..., 2].

    `data` is a Python int or an integer tensor broadcasting against the
    key batch; negative values wrap like jnp.uint32(data)."""
    if torch.is_tensor(data):
        d = data.to(torch.int64) & MASK
    else:
        d = int(data) & MASK
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], zero, d)
    if torch.is_tensor(y1) and y0.shape != y1.shape:
        y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit draws [..., *shape] (int64 holding uint32), partitionable layout."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2^32 draws per key")
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    k1 = k[..., 0][..., None]
    k2 = k[..., 1][..., None]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(k.shape[:-1] + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """(bits >> 9) | bits(1.0f) as f32, minus 1: uniform in [0, 1)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) per key."""
    f = _bits_to_unit(random_bits(k, shape))
    lo = torch.tensor(np.float32(minval), device=k.device)
    hi = torch.tensor(np.float32(maxval), device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# Coefficients of XLA's f32 erf_inv (Giles' approximation), w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 erf_inv with the op sequence of XLA's chlo.erf_inv lowering
    (not torch.erfinv, whose algorithm differs)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device

    def coef(i):
        return torch.where(
            lt,
            torch.tensor(np.float32(_ERFINV_LT5[i]), device=dev),
            torch.tensor(np.float32(_ERFINV_GE5[i]), device=dev),
        )

    # Each Horner step rounds once, as a fused multiply-add: XLA's CPU code
    # contracts `c + p*w` into FMAs. The f32 product is exact in f64, so
    # the f64 step rounded to f32 is that FMA (short of a double rounding).
    w64 = w.double()
    p = coef(0)
    for i in range(1, 9):
        p = (coef(i).double() + p.double() * w64).float()
    result = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), result)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(k: torch.Tensor, shape=()) -> torch.Tensor:
    """jax.random.normal(key, shape, float32) per key (to a few ulps)."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)
