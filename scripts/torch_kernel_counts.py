"""Counts the kernels and host syncs of the main path's bench render, by
kernel name, in this checkout and in others (one card).

    python3 scripts/torch_kernel_counts.py [--other NAME=DIR ...] \
        [--out FILE]

The render is chip_smoke.py's profile phase's: the blob subdiv 6 + room,
1920x1080, 2 spp, 5 bounces, seed 0, waves of 2^20, accels of S 128 and
256. Each checkout runs in a process of its own with its own package on
the path: it renders once warm, then once under torch.profiler with the
host-sync count set to 0 just before. A kernel is a device entry of the
profile that is not a labelled range, as chip_smoke.py counts them.
Prints one JSON line: each checkout's `device_kernels`, `host_syncs`,
`tile_sweep` launches and `by_name`, and each other checkout's `diff`
against this one (count here minus count there, by name).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import wavefront
from path_tracer_ai_tpu_torch.scene.camera import default_camera
from path_tracer_ai_tpu_torch.scene.scene import blob_scene
from path_tracer_ai_tpu_torch.utils import sync

scene = blob_scene(subdivisions=6, device="cuda")
kw = dict(accel=build_clusters(scene.triangles, cluster_size=128),
          accel_closest=build_clusters(scene.triangles, cluster_size=256),
          wave_size=1 << 20, device="cuda")
settings = RenderSettings(width=1920, height=1080, samples_per_pixel=2,
                          max_bounces=5, seed=0)
cam = default_camera("cuda")
wavefront.render(scene, cam, settings, **kw)
torch.cuda.synchronize()
sync.reset()
cuda_ctiles.reset_launches()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    img = wavefront.render(scene, cam, settings, **kw)
    torch.cuda.synchronize()
labels = ("closest_wave", "shadow_wave")
by_name = {}
for e in p.key_averages():
    if (str(e.device_type).endswith("CUDA") and e.key not in labels
            and not e.key.startswith("worklist_")):
        by_name[e.key[:120]] = by_name.get(e.key[:120], 0) + int(e.count)
print(json.dumps({"device_kernels": sum(by_name.values()),
                  "host_syncs": sync.count,
                  "tile_sweep": cuda_ctiles.launches,
                  "image_mean": float(img.mean()), "by_name": by_name}))
"""


def count(directory: str) -> dict:
    env = dict(os.environ, PYTHONPATH=directory)
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=directory,
                         env=env, capture_output=True, text=True,
                         check=False)
    if out.returncode != 0:
        raise RuntimeError(f"{directory}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=DIR", help="another checkout")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
    others = dict(o.split("=", 1) for o in args.other)
    res = {"checkouts": {"this": count(ROOT)}}
    for name, directory in others.items():
        res["checkouts"][name] = count(os.path.abspath(directory))
    here = res["checkouts"]["this"]["by_name"]
    for name in others:
        there = res["checkouts"][name]["by_name"]
        res["checkouts"][name]["diff"] = {
            k: here.get(k, 0) - there.get(k, 0)
            for k in sorted(set(here) | set(there))
            if here.get(k, 0) != there.get(k, 0)}
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
