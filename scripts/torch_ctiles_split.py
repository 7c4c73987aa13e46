"""Splits the main path's device time by the steps of its closest waves.

    python3 scripts/torch_ctiles_split.py [--tree DIR] [--reps N]
        [--out FILE]

DIR holds a checkout of the repository (for example a parent commit,
unpacked with `git archive`; default: this checkout); its
`path_tracer_ai_tpu_torch` is imported and its kernels are built in its own
`_build`. The bench cell: blob subdiv 6 + room, 1920x1080, 2 spp, 5
bounces, seed 0, waves of 2^20, through `wavefront.render` (the main path:
ctiles closest waves on the S = 256 accel, packet-cascade shadows on the
S = 128 one).

The steps of `accel.ctiles._run` that the tree has are wrapped in
torch.profiler ranges (`record_function`): the block sort
(`_prepare_blocks`), the cull (`_ray_masks`, or the `block_cull` kernel),
the extraction (`_extract_order_flat`), the pair build (`_build_pairs`),
the sweep and resolve (`_sweep_resolve`), the overflow fallback and the
unsort; inside them the sweep kernels' wrappers (`cuda_ctiles.tile_sweep`,
`cuda_ctiles.slot_sweep`) too. After one warm render, `reps` timed renders
(synchronised; host reads by call site counted on the first), then one
render under torch.profiler. Each device kernel is charged to the
innermost of these ranges that launched it, else to the wave type
(wavefront's `closest_wave` / `shadow_wave` ranges), else to "other".
Kernels launched through ctypes (the port's own CUDA kernels) have no
torch op to be charged to: they are listed by name under "own_kernels"
(the profile's device time of each, less what was charged). Prints one
JSON line (and writes it to FILE): the card's name and power limit, the
tree, the timed seconds, the host reads by site, the device kernel
seconds in all, charged to ranges (kernels, seconds, the six kernels that
took the most, each range's calls) and the own kernels'. Needs a GPU.
"""

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import time

# (module under path_tracer_ai_tpu_torch.accel, attribute, range label);
# a tree that lacks one leaves it out
WRAPPED = (
    ("ctiles", "_run", "ctiles"),
    ("ctiles", "_prepare_blocks", "ctiles_sort"),
    ("ctiles", "_ray_masks", "ctiles_cull"),
    ("cuda_ctiles", "block_cull", "ctiles_cull"),
    ("ctiles", "_extract_order_flat", "ctiles_extract"),
    ("ctiles", "_build_pairs", "ctiles_pairs"),
    ("ctiles", "_sweep_resolve", "ctiles_sweep_resolve"),
    ("cuda_ctiles", "tile_sweep", "tile_sweep"),
    ("cuda_ctiles", "slot_sweep", "slot_sweep"),
    ("ctiles", "_overflow_fallback", "ctiles_fallback"),
    ("ctiles", "_unsort", "ctiles_unsort"),
)
WAVES = ("closest_wave", "shadow_wave")


def _wrap(mod, attr, label):
    from torch.profiler import record_function

    fn = getattr(mod, attr)

    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)

    setattr(mod, attr, wrapped)


def _charge(events) -> dict:
    """label -> {kernel name -> [count, us]}: each kernel to the innermost
    labelled range above the op that launched it."""
    labels = {lab for _m, _a, lab in WRAPPED} | set(WAVES)
    out = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0, 0.0]))
    for ev in events:
        kernels = getattr(ev, "kernels", None)
        if not kernels:
            continue
        owner, p = "other", ev
        while p is not None:
            if p.name in labels:
                owner = p.name
                break
            p = p.cpu_parent
        for k in kernels:
            slot = out[owner][k.name]
            slot[0] += 1
            slot[1] += float(k.duration)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import path_tracer_ai_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(tree):
        print(f"imported {port.__file__}, not from {tree}", file=sys.stderr)
        return 1
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene
    from path_tracer_ai_tpu_torch.utils import sync

    wrapped = []
    for modname, attr, label in WRAPPED:
        mod = importlib.import_module(f"path_tracer_ai_tpu_torch.accel."
                                      f"{modname}")
        if hasattr(mod, attr):
            _wrap(mod, attr, label)
            wrapped.append(f"{modname}.{attr}")
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

    images = []

    def render():
        return wavefront.render(scene, cam, settings, accel=accel,
                                accel_closest=accel_c, wave_size=1 << 20,
                                device="cuda")

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        images.append(hashlib.sha256(img.tobytes()).hexdigest())
        return time.perf_counter() - t0

    timed()  # warm: builds the kernels
    sync.reset()
    seconds = [timed()]
    reads = sync.count
    sites = dict(sorted(sync.sites.items(), key=lambda kv: -kv[1]))
    seconds += [timed() for _ in range(args.reps - 1)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    charged = _charge(prof.events())
    calls = collections.Counter(ev.name for ev in prof.events()
                                if ev.name in {lab for _m, _a, lab in WRAPPED})
    total_us = sum(us for k in charged.values() for _n, us in k.values())
    ranges = {}
    for label, kernels in sorted(charged.items(),
                                 key=lambda kv: -sum(v[1] for v in
                                                     kv[1].values())):
        us = sum(v[1] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        ranges[label] = {
            "calls": calls.get(label, 0),
            "kernels": sum(v[0] for v in kernels.values()),
            "seconds": us / 1e6,
            "share_of_charged_time": us / total_us if total_us else 0.0,
            "top": [{"name": n[:90], "count": c, "seconds": u / 1e6}
                    for n, (c, u) in top]}
    labels = {lab for _m, _a, lab in WRAPPED} | set(WAVES)
    by_name = collections.defaultdict(float)
    counts = collections.Counter()
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.key not in labels:
            by_name[e.key] += float(getattr(e, "self_device_time_total", 0.0))
            counts[e.key] += int(e.count)
    charged_by_name = collections.defaultdict(float)
    for kernels in charged.values():
        for name, (_c, us) in kernels.items():
            charged_by_name[name] += us
    own = {name: (us - charged_by_name.get(name, 0.0), counts[name])
           for name, us in by_name.items()
           if us - charged_by_name.get(name, 0.0) > 1.0}
    own_us = sum(us for us, _n in own.values())
    all_us = total_us + own_us
    out = {"card": card, "tree": tree, "wrapped": wrapped,
           "timed_seconds": seconds, "image_sha256": sorted(set(images)),
           "host_reads": reads,
           "host_read_sites": sites,
           "device_kernel_seconds": all_us / 1e6,
           "charged_seconds": total_us / 1e6,
           "own_kernel_seconds": own_us / 1e6,
           "busy_share": all_us / 1e6 / min(seconds),
           "own_kernels": [{"name": n[:90], "count": c, "seconds": us / 1e6}
                           for n, (us, c) in sorted(
                               own.items(), key=lambda kv: -kv[1][0])],
           "ranges": ranges}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
