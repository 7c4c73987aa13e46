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

Key data, `uniform` and `normal` are bit-equal to JAX. `normal` needs
log1p as XLA's CPU code computes it in f32 (`log1p_xla`; torch.log1p
rounds its last ulp differently on about 1% of draws).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from path_tracer_ai_tpu_torch.core import vec

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


def _f32(bits: int) -> float:
    return float(np.uint32(bits).view(np.float32))


_FLT_MIN = _f32(0x00800000)
# log1p's two branches as XLA's CPU code evaluates them in f32: Cephes'
# rational approximation P(x) / Q(x) for |x| < sqrt(2) - 1, else log(1 + x)
# with the mantissa m in [sqrt(1/2), sqrt(2)) and Cephes logf's polynomial
# in three interleaved chains; ln 2 in two parts.
_LOG1P_P = tuple(_f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
    0x41A05101))
_LOG1P_Q = tuple(_f32(b) for b in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982))
_LOG_C = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,     # chain a: c0 c1, then c2
    0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,     # chain b: c3 c4, then c5
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))    # chain c: c6 c7, then c8
_LN2_LO, _LN2_HI = _f32(0xB95E8083), _f32(0x3F318000)
_SQRT_HALF, _LOG1P_SMALL = _f32(0x3F3504F3), _f32(0x3ED413CD)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as an FMA instruction does: the product
    of two f32 is exact in f64, and on the inputs log1p_xla gives it, the
    f64 sum rounded to f32 is the FMA's result (checked over its whole
    domain, tests/test_torch_rng.py)."""
    if torch.is_tensor(b):
        b = b.double()
    return (a.double() * b + c).float()


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 log1p with the operations, fusions and order of XLA's CPU code
    (its optimized LLVM IR and machine code for `jnp.log1p`), bit-equal to
    it on every f32 in (-1, 0], the domain erf_inv needs. Denormal inputs
    count as zero, as XLA's CPU code runs with denormals off."""
    x = torch.where(x.abs() < _FLT_MIN, x * 0.0, x)
    # |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x)
    x2 = x * x
    q = torch.ones_like(x)
    for c in _LOG1P_Q:
        q = _fma(x, q, c)
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = _fma(x, p, c)
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))
    # log(1 + x) = e ln 2 + log(1 + xm), 1 + xm = m in [sqrt(1/2), sqrt(2))
    bits = torch.clamp_min(x + 1.0, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [1/2, 1)
    low = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(low, m, 0.0)
    e = torch.where(low, e - 1.0, e)
    z = xm * xm
    x3 = xm * z
    a, b, c = (_fma(xm, _LOG_C[i], _LOG_C[i + 1]) for i in (0, 3, 6))
    a, b, c = (_fma(xm, acc, _LOG_C[i + 2]) for acc, i in ((a, 0), (b, 3),
                                                          (c, 6)))
    poly = _fma(x3, _fma(x3, _fma(x3, a, b), c), e * _LN2_LO)
    large = _fma(e, _LN2_HI, _fma(z, -0.5, xm) + poly)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 erf_inv with the op sequence of XLA's chlo.erf_inv lowering
    (not torch.erfinv, whose algorithm differs)."""
    w = -log1p_xla(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, vec.sqrt_rn(w) - 3.0)
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
    """jax.random.normal(key, shape, float32) per key."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)
