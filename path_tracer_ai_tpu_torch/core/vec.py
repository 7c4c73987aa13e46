"""Vector math on [..., 3] tensors (counterpart of core/vec.py).

`dot` is written out component by component, so the sum order is fixed:
((x0*y0 + x1*y1) + x2*y2), the order of the component-wise sweeps in
accel.traverse. `normalize` has no epsilon guard, like the reference. Every square root
goes through `sqrt_rn`, and every division by a Python number that is not
a power of two through `div_rn`: each correctly rounded on every device,
so the CPU and the card compute the same bits.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's and numpy's are.

    torch's f32 `sqrt` on the CPU is not correctly rounded (it misses by an
    ulp on 0.6-17% of inputs, depending on the host), so a CPU tensor goes
    through f64. That is exact: the square root of an f32 lies at least 4
    f64 ulps from every f32 rounding boundary, and torch's f64 `sqrt` errs
    by at most one. On the card `torch.sqrt` is the IEEE `sqrtf` already
    (one kernel, as before)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def div_rn(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a Python number c, correctly rounded on every device, as
    the CPU divides. torch's CUDA kernels multiply by the f32 reciprocal of
    a scalar divisor instead (an ulp off on a share of inputs), so on the
    card c goes as a 0-dim tensor of the card."""
    if x.device.type == "cpu":
        return x / c
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / length(a)[..., None]


def safe_normalize(a: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    return a / torch.clamp(length(a), min=eps)[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """glm::reflect: I - 2*dot(N,I)*N (renderer.hpp:191,231)."""
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, eta) -> torch.Tensor:
    """glm::refract (renderer.hpp:233); zero vector on total internal
    reflection. `eta` is a tensor broadcasting over leading dims."""
    eta = eta[..., None] if torch.is_tensor(eta) and eta.dim() else eta
    ndi = dot(normal, incident)[..., None]
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = eta * incident - (eta * ndi + sqrt_rn(torch.clamp(k, min=0.0))) * normal
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)
