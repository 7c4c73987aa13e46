"""Writes tests/data/jax_reference.npz: the JAX package's renders of one
small scene, which the port is held against on the CPU
(tests/test_torch_reference.py) and on the card (chip_smoke.py's
`reference` phase, which reads the file without JAX).

    JAX_PLATFORMS=cpu python scripts/torch_make_reference.py [--out PATH]

The scene is the procedural blob (subdivision 3, seed 7) in the room with
the default lights and materials, seen by the default camera; 48x27, 2 spp,
5 bounces, seed 0, once with Russian roulette off (rr_start 0) and once
from bounce 2. The file holds, for each rr_start: JAX's `oracle.render` and
`wavefront.render` (its default backend) images, and the port's on the CPU
through the oracle and the main path (`image_jax_oracle_rr0`,
`image_jax_wavefront_rr0`, `image_port_oracle_rr0`, `image_port_main_rr0`,
...); the scene and camera arrays that both rendered (`tri_*`, `mat_*`,
`light_*`, `cam_*`: JAX's, carried to the port by convert.py); the settings;
and `jax.__version__`. Run it again after a change to either package that
moves a stored image on purpose.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "data", "jax_reference.npz")
SETTINGS = dict(width=48, height=27, spp=2, bounces=5, seed=0,
                subdivisions=3, rr_starts=(0, 2))


def jax_renders(settings: dict) -> tuple[dict, dict]:
    """JAX's scene and camera arrays and its images by name."""
    import jax
    from __graft_entry__ import _demo_scene

    from path_tracer_ai_tpu.config import RenderSettings
    from path_tracer_ai_tpu.engine import oracle, wavefront
    from path_tracer_ai_tpu.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.convert import reference_arrays

    scene, _ = _demo_scene(subdivisions=settings["subdivisions"])
    camera = default_camera()
    arrays = reference_arrays(*([np.asarray(a) for a in part]
                                for part in (*scene, camera)))
    images = {}
    for rr in settings["rr_starts"]:
        s = RenderSettings(width=settings["width"], height=settings["height"],
                           samples_per_pixel=settings["spp"],
                           max_bounces=settings["bounces"],
                           seed=settings["seed"], rr_start=rr)
        images[f"jax_oracle_rr{rr}"] = np.asarray(
            oracle.render(scene, camera, s))
        images[f"jax_wavefront_rr{rr}"] = np.asarray(
            wavefront.render(scene, camera, s))
    arrays["jax_version"] = np.asarray(jax.__version__)
    return arrays, images


def port_renders(ref) -> dict:
    """The port's images on the CPU of a loaded reference (convert.
    load_reference(..., device="cpu")), by name."""
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront

    images = {}
    for rr, s in ref.settings.items():
        images[f"port_oracle_rr{rr}"] = oracle.render(
            ref.scene, ref.camera, s, device="cpu")
        images[f"port_main_rr{rr}"] = wavefront.render(
            ref.scene, ref.camera, s, device="cpu")
    return images


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()

    import torch

    from path_tracer_ai_tpu_torch.convert import load_reference

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    arrays, images = jax_renders(SETTINGS)
    data = {**arrays, **{k: np.asarray(v) for k, v in SETTINGS.items()},
            **{f"image_{k}": v for k, v in images.items()}}
    # the port renders the arrays as they are stored, as the tests and the
    # card load them
    buf = io.BytesIO()
    np.savez(buf, **data)
    buf.seek(0)
    port = port_renders(load_reference(buf, device="cpu"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **data,
                        **{f"image_{k}": v for k, v in port.items()})
    for k, v in port.items():
        jax_img = images["jax_oracle_" + k.rsplit("_", 1)[1]]
        ratio = np.sqrt(np.mean((v - jax_img) ** 2)) / jax_img.mean()
        print(f"{k}: RMSE / mean against JAX's oracle image {ratio:.3e}")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
          f"{time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
