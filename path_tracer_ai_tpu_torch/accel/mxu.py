"""Möller–Trumbore as a matrix product (counterpart of accel/mxu.py): per-ray
features times a per-triangle coefficient matrix.

MT decomposes exactly into one dot of the ray's feature vector
G = [d, o x d, o, 1] (10 floats) with a per-triangle matrix W [10, 4]:

    a     = -d . N                          with N = e1 x e2
    u_num = (o x d) . e2 - d . (e2 x v0)
    v_num = -(o x d) . e1 + d . (e1 x v0)
    t_num = o . N - v0 . N
    u = u_num / a,  v = v_num / a,  t = t_num / a   (MT's guards)

so a block of B rays against K triangles is one [B, 10] @ [10, K * 4]
product. The terms are rearranged, so the bits differ from the elementwise
sweep (the reference's bounds: hit flips < 5e-3, t within rtol 5e-3): an
opt-in intersector of the worklist (`intersector="mxu"`). The reference
leaves the product to XLA (an einsum), outside any Pallas kernel; here it
is one batched matrix product.

Precision, independent of torch's global TF32 flags (the reference's names
are the TPU matrix unit's passes, written out here): "highest" multiplies
the f32 operands exactly and rounds each sum once to f32; "high" splits
each operand into bf16 `hi` and `lo` parts and sums hi.hi + hi.lo + lo.hi
(bf16 x 3); "default" keeps hi.hi alone (one bf16 pass). Every product of
two such operands is exact in f64, where the sums run, so no TF32 mode
enters and the CPU and the card agree up to the sums' order.
"""

from __future__ import annotations

import torch

from path_tracer_ai_tpu_torch.core import vec
from path_tracer_ai_tpu_torch.core.types import MT_EPSILON

PRECISIONS = ("highest", "high", "default")


def build_linear_table(accel) -> torch.Tensor:
    """Per-cluster coefficient matrices W: [C, 10, S, 4] f32."""
    v0, e1, e2 = accel.v0, accel.e1, accel.e2                 # [C, S, 3]
    n = vec.cross(e1, e2)
    e2xv0 = vec.cross(e2, v0)
    e1xv0 = vec.cross(e1, v0)
    c, s, _ = v0.shape
    w = torch.zeros((c, s, 10, 4), dtype=torch.float32, device=v0.device)
    w[..., 0:3, 0] = -n                     # a:      d . (-N)
    w[..., 0:3, 1] = -e2xv0                 # u_num:  d . -(e2 x v0)
    w[..., 3:6, 1] = e2                     #        (o x d) . e2
    w[..., 0:3, 2] = e1xv0                  # v_num:  d . (e1 x v0)
    w[..., 3:6, 2] = -e1                    #        (o x d) . -e1
    w[..., 6:9, 3] = n                      # t_num:  o . N
    w[..., 9, 3] = -(v0 * n).sum(dim=-1)
    return w.permute(0, 2, 1, 3).contiguous()                 # [C, 10, S, 4]


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[..., 3] x2 -> [..., 10] feature vectors G = [d, o x d, o, 1]."""
    ones = torch.ones(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)
    return torch.cat([d, vec.cross(o, d), o, ones], dim=-1)


def _split_bf16(x: torch.Tensor):
    """x = hi + lo + rest: hi = x rounded to bf16, lo = the remainder
    rounded to bf16 (both held in f32)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def linear_product(g_feat, wg, precision: str = "highest") -> torch.Tensor:
    """[I, B, 10] x [I, 10, K, 4] -> [I, B, K, 4] f32 at a precision of
    PRECISIONS (see the module docstring)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    i, f, k, q = wg.shape
    w = wg.reshape(i, f, k * q)
    if precision != "highest":
        gh, gl = _split_bf16(g_feat)
        wh, wl = _split_bf16(w)
        if precision == "high":
            g_feat = torch.cat([gh, gh, gl], dim=2)
            w = torch.cat([wh, wl, wh], dim=1)
        else:
            g_feat, w = gh, wh
    out = torch.bmm(g_feat.double(), w.double())
    return out.to(torch.float32).reshape(i, -1, k, q)


def mxu_sweep(g_feat, wg, t_min, t_max_blk, precision: str = "highest"):
    """Dense intersection through the linear table.

    g_feat: [I, B, 10] ray features; wg: [I, 10, K, 4] gathered cluster
    tables (K = group * S triangles); t_min a float or a tensor that
    broadcasts against [I, B, K]; t_max_blk: [I, B]. Returns (t [I, B, K],
    inf where invalid, ok), traverse._mt_sweep's contract."""
    q = linear_product(g_feat, wg, precision)                 # [I, B, K, 4]
    a = q[..., 0]
    ok = torch.abs(a) > MT_EPSILON
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    u = q[..., 1] * f
    v = q[..., 2] * f
    t = q[..., 3] * f
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    ok = ok & (t >= t_min) & (t <= t_max_blk[:, :, None])
    return torch.where(ok, t, torch.full_like(t, float("inf"))), ok
