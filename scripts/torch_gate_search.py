"""Counts the Möller–Trumbore hits that the closest sweeps' sub_skip gate
would skip, on the CPU.

    python3 scripts/torch_gate_search.py [--rays N] [--seed S]

For each of five placements of random triangles (vertices in a cube of
half-width `size` around a centre on the diagonal at `centre`), N rays
that end exactly on a vertex of their triangle (a corner of its box, the
hardest place for the gate) or, for a third of them, at a random point of
it, from its front side, after t in [0.001, 0.1], directions uniform. Each
ray's window ends at the test's own t (cuda_ctiles.mt_sweep_rows), as a
running best of that t would end it. The script prints one JSON line: by
placement, the hits, and how many of them each gate skips: the box itself
with the window's end widened by 2^-16 of itself (the gate that the port
had first), and cuda_closest.gate_lanes (the box grown by GATE_PAD of the
largest coordinate magnitude). Needs no GPU.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from path_tracer_ai_tpu_torch.accel import cuda_closest, cuda_ctiles  # noqa

PLACEMENTS = ((0.0, 1.0), (1.0, 1.0), (10.0, 1.0), (100.0, 1.0),
              (100.0, 10.0))  # (centre, size)


def _tensor(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32))


def placement(rng, n: int, centre: float, size: float) -> dict:
    f32 = np.float32
    p = (centre + rng.uniform(-1, 1, (n, 3, 3)) * size).astype(f32)
    v0 = p[:, 0]
    e1 = (p[:, 1] - p[:, 0]).astype(f32)
    e2 = (p[:, 2] - p[:, 0]).astype(f32)
    a = rng.uniform(0, 1, n)
    b = rng.uniform(0, 1, n) * (1 - a)
    at_vertex = rng.integers(0, 3, n) < 2
    a, b = np.where(at_vertex, 0.0, a), np.where(at_vertex, 0.0, b)
    hit = v0 + a[:, None] * e1 + b[:, None] * e2
    normal = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where((np.sum(d * normal, 1) > 0)[:, None], -d, d).astype(f32)
    o = (hit - rng.uniform(1e-3, 0.1, n)[:, None] * d).astype(f32)
    t_min = 1e-6
    t, _ok = cuda_ctiles.mt_sweep_rows(
        *(_tensor(x[:, i]) for x in (o, d, v0, e1, e2) for i in range(3)),
        _tensor(np.full(n, t_min)), _tensor(np.full(n, np.inf)))
    found = torch.isfinite(t)
    box = _tensor(np.concatenate([p.min(1), p.max(1)], 1))
    rays = torch.zeros((n, 8, 1))
    rays[:, 0:3, 0] = _tensor(o)
    rays[:, 3:6, 0] = _tensor(d)
    inv = 1.0 / rays[:, 3:6]
    cap = t[:, None]
    t_lo = torch.full((n, 1), t_min)
    # the first gate, one ray a block: its own slab test in sub_pred's form
    lo, hi = t_lo, cap + cap.abs() * 2.0 ** -16
    for axis in range(3):
        t0 = (box[:, axis, None] - rays[:, axis]) * inv[:, axis]
        t1 = (box[:, 3 + axis, None] - rays[:, axis]) * inv[:, axis]
        neg = inv[:, axis] < 0.0
        near, far = torch.where(neg, t1, t0), torch.where(neg, t0, t1)
        lo = torch.where(near > lo, near, lo)
        hi = torch.where(far < hi, far, hi)
    widened = (hi >= lo)[:, 0]
    grown = cuda_closest.gate_lanes(box, rays, inv, t_lo, cap)[:, 0]
    return {"centre": centre, "size": size, "hits": int(found.sum()),
            "skipped_cap_widened_2^-16": int((found & ~widened).sum()),
            "skipped_gate_lanes": int((found & ~grown).sum())}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rays", type=int, default=400_000)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    rng = np.random.default_rng(args.seed)
    rows = [placement(rng, args.rays, c, s) for c, s in PLACEMENTS]
    print(json.dumps({"rays_per_placement": args.rays, "seed": args.seed,
                      "gate_pad": cuda_closest.GATE_PAD,
                      "placements": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
