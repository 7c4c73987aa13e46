"""Command-line entry point (counterpart of cli.py; mirrors
src/main.cpp:10-126).

    python -m path_tracer_ai_tpu_torch.cli -m gpu -i model.obj -o out.png

The reference's 8 flags with its defaults (main.cpp:15-24):

    -m/--mode cpu|gpu|tpu   (default gpu; cpu = the oracle engine, gpu and
                             tpu = the wavefront engine)
    -w/--width 800   -h/--height 450   -s/--samples 100   -b/--bounces 5
    -g/--gamma 2.2   -i/--input IronMan/IronMan.obj   -o/--output output.png

and the JAX package's extensions: --seed, --aspect, --dielectric, --rr,
--checkpoint / --checkpoint-every, --tile-devices (the frame sharded over
N devices: every visible card, or N virtual CPU entries with
PT_PLATFORM=cpu), --scheduler wave|pool, --backend, --validate and
--profile.

Both modes run on the card; PT_PLATFORM=cpu runs them on the CPU. Unlike
the reference (main.cpp:98-113) and the JAX CLI, a failed accelerated
render is NOT rerun on the oracle: the error is logged and main returns 1,
so a kernel that does not build or launch cannot hide behind a fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.engine import oracle, wavefront
from path_tracer_ai_tpu_torch.io.image import save_image
from path_tracer_ai_tpu_torch.scene.camera import default_camera
from path_tracer_ai_tpu_torch.scene.scene import build_scene
from path_tracer_ai_tpu_torch.utils.debug import validate_image
from path_tracer_ai_tpu_torch.utils.logging import (
    configure_cli_logging,
    get_logger,
)
from path_tracer_ai_tpu_torch.utils.profiling import trace

# Named, not __name__: under `python -m` the module runs as __main__,
# outside the package logger that configure_cli_logging sets up.
log = get_logger("path_tracer_ai_tpu_torch.cli")

BACKENDS = ["packets", "worklist", "pairs", "hybrid", "kslots", "ctiles",
            "perray", "pallas"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path-tracer-torch",
        description="Path tracer on an NVIDIA GPU (PyTorch/CUDA port)",
        add_help=False,  # the reference uses -h for height (main.cpp:18)
    )
    p.add_argument("-m", "--mode", default="gpu", choices=["cpu", "gpu", "tpu"],
                   help="Rendering mode (cpu = oracle engine, gpu/tpu = wavefront engine)")
    p.add_argument("-w", "--width", type=int, default=800, help="Image width")
    p.add_argument("-h", "--height", type=int, default=450, help="Image height")
    p.add_argument("-s", "--samples", type=int, default=100, help="Samples per pixel")
    p.add_argument("-b", "--bounces", type=int, default=5, help="Maximum ray bounces")
    p.add_argument("-g", "--gamma", type=float, default=2.2, help="Gamma correction value")
    p.add_argument("-i", "--input", default="IronMan/IronMan.obj", help="Input OBJ file path")
    p.add_argument("-o", "--output", default="output.png", help="Output image file path")
    p.add_argument("--help", action="help", help="Print help")
    # --- extensions beyond the reference CLI -------------------------------
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed (reference is entropy-seeded; pass -1 for that)")
    p.add_argument("--aspect", default="fixed", choices=["fixed", "true"],
                   help="fixed = reference 16:9 camera quirk (default), true = real aspect")
    p.add_argument("--dielectric", action="store_true",
                   help="enable dielectric materials from MTL (glass/illum 7/d<1)")
    p.add_argument("--rr", type=int, default=0, metavar="N",
                   help="Russian roulette from bounce N (unbiased "
                        "throughput-proportional termination; 0 = off, "
                        "matching the reference's fixed-depth cutoff)")
    p.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint file for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N sample-passes (0 = only at end)")
    p.add_argument("--tile-devices", type=int, default=0,
                   help="shard the framebuffer across N devices (0 = single "
                        "device)")
    p.add_argument("--scheduler", default="wave", choices=["wave", "pool"],
                   help="wavefront scheduler: bounded-depth waves or "
                        "persistent pool")
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="traversal backend (default: hybrid, worklist past "
                        "2048 clusters)")
    p.add_argument("--validate", action="store_true",
                   help="audit the final image for NaN/Inf/sentinel pixels")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render into DIR")
    return p


def cli_device():
    """The device both modes run on: cuda (raises RuntimeError without a
    GPU), or the CPU when PT_PLATFORM=cpu."""
    return resolve_device("cpu" if os.environ.get("PT_PLATFORM") == "cpu"
                          else None)


def main(argv=None) -> int:
    configure_cli_logging()
    args = build_parser().parse_args(argv)
    try:
        dev = cli_device()
    except RuntimeError as e:
        log.error("%s (set PT_PLATFORM=cpu to render on the CPU)", e)
        return 1

    settings = RenderSettings(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.samples,
        max_bounces=args.bounces,
        gamma=args.gamma,
        aspect_mode=args.aspect,
        seed=None if args.seed == -1 else args.seed,
        rr_start=args.rr,
    )

    try:
        scene = build_scene(args.input, enable_dielectrics=args.dielectric,
                            device=dev)
    except (OSError, ValueError) as e:
        log.error("Failed to load model: %s (%s)", args.input, e)
        return 1
    camera = default_camera(dev)

    with trace(args.profile) if args.profile else contextlib.nullcontext():
        start = time.perf_counter()
        if args.mode == "cpu":
            image = oracle.render(scene, camera, settings, show_progress=True,
                                  device=dev)
        else:
            try:
                image = wavefront.render(
                    scene, camera, settings,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    tile_devices=args.tile_devices or None,
                    scheduler=args.scheduler, backend=args.backend,
                    device=dev,
                )
            except Exception:  # noqa: BLE001 — report, do not fall back
                log.exception("Accelerated rendering failed; no oracle "
                              "fallback is taken")
                return 1
        log.info("Rendering completed in %.3f seconds",
                 time.perf_counter() - start)

    if args.validate:
        log.info("Image audit: %s", validate_image(image))

    save_image(args.output, image, settings.gamma)
    return 0


if __name__ == "__main__":
    sys.exit(main())
