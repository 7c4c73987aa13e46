"""Measures, on this host's CPU, the rounding of the f32 operations that the
port's shared paths take from a math library: torch's and XLA's against
the correctly rounded result (numpy's f64 rounded once), and the port's
helpers (`core/vec.sqrt_rn`, `div_rn`, the camera's f64 tangent) beside
them. chip_smoke.py's device phase measures the card's.

    JAX_PLATFORMS=cpu python scripts/torch_numerics_audit.py

Prints one JSON line. Counts are of f32 results whose bits differ from the
correctly rounded ones, unless a key says otherwise.
"""

from __future__ import annotations

import json
import math
import os
import platform
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    return int((a.view(np.int32) != b.view(np.int32)).sum())


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from path_tracer_ai_tpu.scene import camera as jcamera
    from path_tracer_ai_tpu_torch.convert import camera_from_numpy
    from path_tracer_ai_tpu_torch.core import vec
    from path_tracer_ai_tpu_torch.scene import camera

    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 50.0, 1 << 20).astype(np.float32)
    sqrt_rn = np.sqrt(x.astype(np.float64)).astype(np.float32)
    x64 = rng.uniform(0.0, 50.0, 1 << 20)
    f64_ulps = np.abs(torch.sqrt(torch.from_numpy(x64)).numpy().view(np.int64)
                      - np.sqrt(x64).view(np.int64))

    fov = np.arange(4, 680, dtype=np.float32) / np.float32(4.0)
    half = fov * np.float32(math.pi / 180.0) / np.float32(2.0)
    tan_rn = np.tan(half.astype(np.float64)).astype(np.float32)
    at45 = int(np.nonzero(fov == 45.0)[0][0])
    tan_torch = torch.tan(torch.from_numpy(half)).numpy()
    tan_xla = np.asarray(jax.jit(jnp.tan)(jnp.asarray(half)))

    q = rng.random(1 << 16).astype(np.float32)
    div = q / np.float32(math.pi)
    recip = q * (np.float32(1.0) / np.float32(math.pi))
    div_xla = np.asarray(jax.jit(lambda a: a / math.pi)(jnp.asarray(q)))

    jcam = jcamera.default_camera()
    cam = camera_from_numpy(*(np.asarray(a) for a in jcam), device="cpu")
    u, v = (rng.random(4096).astype(np.float32) for _ in range(2))
    d_port = camera.get_rays(cam, torch.from_numpy(u), torch.from_numpy(v),
                             16 / 9)[1].numpy()
    d_eager = jcamera.get_rays(jcam, jnp.asarray(u), jnp.asarray(v), 16 / 9)[1]
    d_jit = jax.jit(jcamera.get_rays, static_argnums=3)(
        jcam, jnp.asarray(u), jnp.asarray(v), 16 / 9)[1]

    print(json.dumps({
        "host": {"cpu": _cpu_model(), "torch": torch.__version__,
                 "torch_cpu_capability":
                     torch.backends.cpu.get_cpu_capability(),
                 "jax": jax.__version__, "numpy": np.__version__},
        "sqrt_f32_inputs": int(x.size),
        "torch_sqrt_f32_differing": _differ(
            torch.sqrt(torch.from_numpy(x)).numpy(), sqrt_rn),
        "numpy_sqrt_f32_differing": _differ(np.sqrt(x), sqrt_rn),
        "xla_sqrt_f32_differing": _differ(
            np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(x))), sqrt_rn),
        "sqrt_rn_differing": _differ(vec.sqrt_rn(torch.from_numpy(x)).numpy(),
                                     sqrt_rn),
        "torch_sqrt_f64_max_ulps_from_numpy": int(f64_ulps.max()),
        "torch_sqrt_f64_differing_from_numpy": int((f64_ulps > 0).sum()),
        "tan_fovs": int(fov.size),
        "torch_tan_f32_differing": _differ(tan_torch, tan_rn),
        "torch_tan_f32_differs_at_45": bool(tan_torch[at45] != tan_rn[at45]),
        "xla_tan_f32_differing": _differ(tan_xla, tan_rn),
        "xla_tan_f32_differs_at_45": bool(tan_xla[at45] != tan_rn[at45]),
        "div_by_pi_inputs": int(q.size),
        "xla_jit_div_by_pi_differing_from_division": _differ(div_xla, div),
        "xla_jit_div_by_pi_differing_from_reciprocal_product": _differ(
            div_xla, recip),
        "div_rn_differing_from_division": _differ(
            vec.div_rn(torch.from_numpy(q), math.pi).numpy(), div),
        "camera_ray_components": int(d_port.size),
        "camera_rays_differing_eager_jax": _differ(d_port, d_eager),
        "camera_rays_differing_jit_jax": _differ(d_port, d_jit),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
