"""Times the port's routes on the bench cell, in one process, for the tree
given (default: this checkout).

    python3 scripts/torch_route_timing.py [--tree DIR] [--reps N]
        [--routes main_path,virtual_mesh_2x2,fused,pallas,pool]
        [--profile fused,...]

DIR holds a checkout of the repository (for example a parent commit,
unpacked with `git archive`); its `path_tracer_ai_tpu_torch` is imported
and its kernels are built in its own `_build`. The bench cell: blob subdiv
6 + room, 1920x1080, 2 spp, 5 bounces, seed 0. Routes: the main path
(`wavefront.render`, waves of 2^20), `render_sharded_wavefront` over a
virtual (2, 2) mesh of cuda:0, the fused cascades (and, as "fused_exact",
the same with exact_cull=16 in both engines), `backend="pallas"`
(blocks of 64) and the pool scheduler. After one warm render of each, each
of `reps` rounds renders every route in turn, synchronised, and the script
prints one JSON line: the card's name and power limit, the tree, each
round's seconds and each route's time over the main path's. Run two trees
in turns within one call (parent, change, change, parent) to compare them
on one card. Needs a GPU.

--profile ROUTES: after the rounds, each of these routes renders twice
more: once with the tree's host-read counts (utils.sync, by call site
where the tree has them) and kernel launch counts set to 0, and once under
torch.profiler (device kernels and their seconds, the busy share over the
route's fastest round, and the kernels whose symbols name a cascade's
sweep or stage). The JSON line then also holds "profiles".
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
    parser.add_argument("--profile", default="",
                        help="routes to split by host-read site and kernel")
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
    def fused(exact_cull=0):
        saved = (wavefront.HYBRID_CLOSEST_KW, wavefront.HYBRID_OCCLUDE_KW)
        wavefront.HYBRID_CLOSEST_KW = dict(engine="cascade_fused",
                                           exact_cull=exact_cull)
        wavefront.HYBRID_OCCLUDE_KW = dict(engine="packets_fused",
                                           early_skip=True, sub_skip=True,
                                           exact_cull=exact_cull)
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
        "fused_exact": lambda: fused(exact_cull=16),
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
    out = {"card": card, "tree": tree, "rounds": rounds,
           "over_main_path_by_sums": {
               name: sum(r[name] for r in rounds) / main_sum
               for name in runs if name != "main_path"}}
    profiled = [n for n in args.profile.split(",") if n]
    if profiled:
        out["profiles"] = {name: _profile(runs[name], timed, min(
            r[name] for r in rounds)) for name in profiled}
    print(json.dumps(out))
    return 0


# Substrings of the kernel symbols that a cascade's sweep or stage runs.
CASCADE_KERNELS = ("block_anyhit_kernel", "block_closest_kernel",
                   "cascade_stage_kernel", "tile_sweep_kernel")
# The kernel wrappers' modules and their launch counts (module attribute).
LAUNCH_COUNTS = ("cuda_anyhit", "cuda_closest", "cuda_cascade", "cuda_ctiles")


def _launch_counts() -> dict:
    import importlib

    out = {}
    for name in LAUNCH_COUNTS:
        try:
            mod = importlib.import_module(
                f"path_tracer_ai_tpu_torch.accel.{name}")
        except ImportError:
            continue
        n = getattr(mod, "launches", None)
        out[name] = dict(n) if isinstance(n, dict) else n
    return out


def _reset_launches() -> None:
    import importlib

    for name in LAUNCH_COUNTS:
        try:
            importlib.import_module(
                f"path_tracer_ai_tpu_torch.accel.{name}").reset_launches()
        except ImportError:
            continue


def _profile(fn, timed, best_seconds) -> dict:
    """One render with the host reads and launches counted, one under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.utils import sync

    sync.reset()
    _reset_launches()
    seconds = timed(fn)
    res = {"seconds": seconds, "host_reads": sync.count,
           "host_read_sites": dict(sorted(
               getattr(sync, "sites", {}).items(), key=lambda kv: -kv[1])),
           "launches": _launch_counts()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, key):
                return float(getattr(e, key))
        return 0.0

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.key not in ("closest_wave", "shadow_wave")
               and not e.key.startswith("worklist_")]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    res.update({
        "device_kernels": int(sum(e.count for e in kernels)),
        "device_seconds": busy, "busy_share": busy / best_seconds,
        "cascade_kernels": [
            {"name": e.key[:100], "count": int(e.count),
             "seconds": dev_us(e) / 1e6} for e in kernels
            if any(k in e.key for k in CASCADE_KERNELS)]})
    return res


if __name__ == "__main__":
    sys.exit(main())
