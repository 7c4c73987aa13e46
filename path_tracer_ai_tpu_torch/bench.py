"""Benchmark harness of the port: prints ONE JSON line with the headline
metric (counterpart of the repository's root bench.py, without its TPU
supervisor and adoption artifact).

    python -m path_tracer_ai_tpu_torch.bench [--subdiv 7] [--backend worklist]

Metric: live Mrays/s on one GPU rendering the blob + room scene (subdiv 6:
81,928 triangles) at 1920x1080, 2 spp, 5 bounces, seed 0: a warm pass,
then one timed wavefront.render with block_size=64 and waves of 2^20. Rays
counted are live closest-hit plus live shadow rays (wavefront.RenderStats).
Diagnostics go to stderr; stdout carries exactly one JSON line: metric,
value, seconds, rays, the backend as resolved, triangles, clusters, and the
card's name and power limit. It only emits the metric: which cells are
measured, and their bounds, are a benchmark's business. It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """`name, power.limit` as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--subdiv", type=int, default=6)  # 20*4^6 = 81920 tris
    ap.add_argument("--quick", action="store_true", help="tiny config for smoke")
    ap.add_argument("--backend", default=None,
                    help="traversal backend override (worklist/packets/pairs)")
    ap.add_argument("--cluster-size", type=int, default=128)
    args = ap.parse_args(argv)
    if args.quick:
        args.width, args.height, args.spp, args.subdiv = 320, 180, 2, 3
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the bench measures the GPU only")
        return 1
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scene = blob_scene(subdivisions=args.subdiv, device=dev)
    accel = build_clusters(scene.triangles, cluster_size=args.cluster_size)
    backend = wavefront.resolve_backend(accel, 64, False, args.backend)
    accel_c = None
    s_cl = wavefront.HYBRID_CLOSEST_CLUSTER_SIZE
    if backend == "hybrid" and s_cl != accel.cluster_size:
        accel_c = build_clusters(scene.triangles, cluster_size=s_cl)
    torch.cuda.synchronize()
    log(f"scene: {scene.triangles.count} tris, accel {accel.num_clusters}x"
        f"{accel.cluster_size}, backend {backend} "
        f"({time.perf_counter() - t0:.2f}s build)")

    camera = default_camera(dev)
    settings = RenderSettings(width=args.width, height=args.height,
                              samples_per_pixel=args.spp,
                              max_bounces=args.bounces, seed=0)
    kw = dict(accel=accel, accel_closest=accel_c, block_size=64,
              wave_size=1 << 20, backend=backend, device=dev)
    t0 = time.perf_counter()
    wavefront.render(scene, camera, settings.replace(
        samples_per_pixel=min(args.spp, 2)), **kw)
    torch.cuda.synchronize()
    log(f"warm pass: {time.perf_counter() - t0:.1f}s")

    stats = wavefront.RenderStats()
    img = wavefront.render(scene, camera, settings, stats=stats, **kw)
    log(f"render {args.width}x{args.height}@{args.spp}spp/{args.bounces}b: "
        f"{stats.seconds:.2f}s, {stats.total_rays / 1e6:.1f}M rays, "
        f"{stats.mrays_per_s:.2f} Mrays/s")
    if not np.isfinite(img).all():
        log("the image is not finite")
        return 1
    print(json.dumps({
        "metric": f"Mrays/s ({args.width}x{args.height}, {args.spp} spp, "
                  f"{args.bounces} bounces, blob subdiv {args.subdiv}, "
                  "wavefront engine, one GPU)",
        "value": stats.mrays_per_s, "unit": "Mrays/s",
        "seconds": stats.seconds, "rays": stats.total_rays,
        "backend": backend, "triangles": scene.triangles.count,
        "clusters": accel.num_clusters, "card": card(),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
