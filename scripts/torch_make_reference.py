"""Writes tests/data/jax_reference.npz,
tests/data/jax_reference_dielectric.npz and
tests/data/jax_reference_cornell.npz: the JAX package's renders of three
small frames, which the port is held against on the CPU
(tests/test_torch_reference.py, tests/test_torch_reference_dielectric.py,
tests/test_torch_reference_cornell.py) and on the card (chip_smoke.py's
`reference` phase, which reads the files without JAX).

    JAX_PLATFORMS=cpu python scripts/torch_make_reference.py \
        [--frame room|dielectric|cornell] [--out PATH]

Without --frame it writes all three. "room": the procedural blob (subdivision
3, seed 7) in the room with the default lights and materials, seen by the
default camera; 48x27, 2 spp, 5 bounces, seed 0, once with Russian
roulette off (rr_start 0) and once from bounce 2. "dielectric": the JAX
package's `dielectric` benchmark configuration's scene
(path_tracer_ai_tpu/benchmarks.py: the blob written as an OBJ, subdivision
3 here, loaded with dielectrics on) and the default camera; 48x27, 2 spp,
8 bounces, seed 0, rr_start 0. The configuration's own MTL (Kd, Ni 1.45)
names no transparency, and the loader makes a material glass only by name,
`illum 7` or `d` < 1 (scene/scene.py _convert_mtl_material), so as written
its blob stays specular; the frame adds `illum 7` to that MTL, which makes
the blob glass of IOR 1.45. "cornell": the JAX package's `cornell`
benchmark configuration's scene and camera (path_tracer_ai_tpu/
benchmarks.py, scene/cornell.py `build_cornell_scene`: a 2-unit box of
axis-aligned quads with two white boxes inside, one point light); 48x27, 2
spp, 5 bounces, seed 0, rr_start 0 (its file stores subdivisions 0: no
blob). A file holds, for each rr_start: JAX's
`oracle.render` and
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
# frame -> (file, settings)
FRAMES = {
    "room": (OUT, SETTINGS),
    "dielectric": (
        os.path.join(ROOT, "tests", "data", "jax_reference_dielectric.npz"),
        dict(width=48, height=27, spp=2, bounces=8, seed=0, subdivisions=3,
             rr_starts=(0,))),
    "cornell": (
        os.path.join(ROOT, "tests", "data", "jax_reference_cornell.npz"),
        dict(width=48, height=27, spp=2, bounces=5, seed=0, subdivisions=0,
             rr_starts=(0,))),
}


def jax_scene(frame: str, subdivisions: int):
    """JAX's scene and camera of a frame."""
    from path_tracer_ai_tpu.scene.camera import default_camera

    if frame == "cornell":
        from path_tracer_ai_tpu.scene.cornell import build_cornell_scene

        return build_cornell_scene()
    if frame == "dielectric":
        import tempfile

        from path_tracer_ai_tpu.benchmarks import get_configs
        from path_tracer_ai_tpu.scene.procgen import write_obj
        from path_tracer_ai_tpu.scene.scene import build_scene

        with tempfile.TemporaryDirectory() as d:
            obj = write_obj(os.path.join(d, "blob.obj"),
                            subdivisions=subdivisions)
            with open(os.path.join(d, "blob.mtl"), "a") as fh:
                fh.write("illum 7\n")  # glass (see the module)
            scene = build_scene(obj, enable_dielectrics=get_configs()[
                "dielectric"].dielectric)
        return scene, default_camera()
    from __graft_entry__ import _demo_scene

    scene, _ = _demo_scene(subdivisions=subdivisions)
    return scene, default_camera()


def jax_renders(settings: dict, frame: str = "room") -> tuple[dict, dict]:
    """JAX's scene and camera arrays and its images by name."""
    import jax

    from path_tracer_ai_tpu.config import RenderSettings
    from path_tracer_ai_tpu.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.convert import reference_arrays

    scene, camera = jax_scene(frame, settings["subdivisions"])
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


def write_frame(frame: str, out: str) -> None:
    import torch

    from path_tracer_ai_tpu_torch.convert import load_reference

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    settings = FRAMES[frame][1]
    arrays, images = jax_renders(settings, frame)
    data = {**arrays, **{k: np.asarray(v) for k, v in settings.items()},
            **{f"image_{k}": v for k, v in images.items()}}
    # the port renders the arrays as they are stored, as the tests and the
    # card load them
    buf = io.BytesIO()
    np.savez(buf, **data)
    buf.seek(0)
    port = port_renders(load_reference(buf, device="cpu"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data,
                        **{f"image_{k}": v for k, v in port.items()})
    for k, v in port.items():
        jax_img = images["jax_oracle_" + k.rsplit("_", 1)[1]]
        ratio = np.sqrt(np.mean((v - jax_img) ** 2)) / jax_img.mean()
        print(f"{frame} {k}: RMSE / mean against JAX's oracle image "
              f"{ratio:.3e}")
    print(f"wrote {out} ({os.path.getsize(out)} bytes, "
          f"{time.perf_counter() - t0:.1f} s)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frame", choices=sorted(FRAMES))
    parser.add_argument("--out", help="the file (with --frame only)")
    args = parser.parse_args()
    if args.out and not args.frame:
        parser.error("--out needs --frame")
    for frame in [args.frame] if args.frame else FRAMES:
        write_frame(frame, args.out or FRAMES[frame][0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
