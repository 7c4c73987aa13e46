"""Times the port's routes on the bench cell, in one process, for the tree
given (default: this checkout).

    python3 scripts/torch_route_timing.py [--tree DIR] [--reps N]
        [--routes main_path,virtual_mesh_2x2,fused,pallas,pool]

DIR holds a checkout of the repository (for example a parent commit,
unpacked with `git archive`); its `path_tracer_ai_tpu_torch` is imported
and its kernels are built in its own `_build`. The bench cell: blob subdiv
6 + room, 1920x1080, 2 spp, 5 bounces, seed 0. Routes: the main path
(`wavefront.render`, waves of 2^20), `render_sharded_wavefront` over a
virtual (2, 2) mesh of cuda:0, the fused cascades, `backend="pallas"`
(blocks of 64) and the pool scheduler. After one warm render of each, each
of `reps` rounds renders every route in turn, synchronised, and the script
prints one JSON line: the card's name and power limit, the tree, each
round's seconds and each route's time over the main path's. Run two trees
in turns within one call (parent, change, change, parent) to compare them
on one card. Needs a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--routes",
                        default="main_path,virtual_mesh_2x2,fused,pallas,"
                        "pool")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    import path_tracer_ai_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(tree):
        print(f"imported {port.__file__}, not from {tree}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.splitlines()[0].strip()
    scene = blob_scene(subdivisions=6, device="cuda")
    accel = build_clusters(scene.triangles, cluster_size=128)
    accel_c = build_clusters(scene.triangles, cluster_size=256)
    cam = default_camera("cuda")
    settings = RenderSettings(width=1920, height=1080, samples_per_pixel=2,
                              max_bounces=5, seed=0)
    grid = mesh.make_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)
    def fused():
        saved = (wavefront.HYBRID_CLOSEST_KW, wavefront.HYBRID_OCCLUDE_KW)
        wavefront.HYBRID_CLOSEST_KW = dict(engine="cascade_fused")
        wavefront.HYBRID_OCCLUDE_KW = dict(engine="packets_fused",
                                           early_skip=True, sub_skip=True)
        try:
            return wavefront.render(scene, cam, settings, accel=accel,
                                    wave_size=1 << 20, device="cuda")
        finally:
            wavefront.HYBRID_CLOSEST_KW, wavefront.HYBRID_OCCLUDE_KW = saved

    every = {
        "main_path": lambda: wavefront.render(
            scene, cam, settings, accel=accel, accel_closest=accel_c,
            wave_size=1 << 20, device="cuda"),
        "virtual_mesh_2x2": lambda: mesh.render_sharded_wavefront(
            scene, cam, settings, grid, accel=accel),
        "fused": fused,
        "pallas": lambda: wavefront.render(
            scene, cam, settings, accel=accel, backend="pallas",
            block_size=64, wave_size=1 << 20, device="cuda"),
        "pool": lambda: wavefront.render(
            scene, cam, settings, accel=accel, scheduler="pool",
            wave_size=1 << 20, device="cuda"),
    }
    names = args.routes.split(",")
    if "main_path" not in names or not set(names) <= set(every):
        print(f"--routes takes main_path and any of {sorted(every)}",
              file=sys.stderr)
        return 1
    runs = {name: every[name] for name in names}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for fn in runs.values():
        timed(fn)  # warm
    rounds = []
    for _ in range(args.reps):
        rounds.append({name: timed(fn) for name, fn in runs.items()})
    main_sum = sum(r["main_path"] for r in rounds)
    print(json.dumps({"card": card, "tree": tree, "rounds": rounds,
                      "over_main_path_by_sums": {
                          name: sum(r[name] for r in rounds) / main_sum
                          for name in runs if name != "main_path"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
