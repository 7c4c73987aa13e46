"""Splits the main path's device time by the steps of its two wave types.

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
`cuda_ctiles.slot_sweep`) too. The packet cascades of the shadow waves
(`accel.traverse.any_hit_packets`, and `closest_hit_packets` where a
closest fallback takes it) are split the same way: the coherence sort
(`_sort_rays`), the interval cull (`_block_candidates`, or the
`packet_cull` kernel's wrapper `cuda_cull.block_candidates`), the ray pack
(`pack_block_rays`), the compaction between stages (`_cascade_stages`
less its `cuda_cascade.cascade_stage` calls), `_unpermute_blocks` and
`_unsort`; the rest of a query goes to `packet_query`. After one warm
render, `reps` timed renders (synchronised; host reads by call site
counted on the first), then one
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
    # the packet cascades (the shadow waves' any_hit_packets): what the
    # steps below leave of a query is charged to its own range
    ("traverse", "any_hit_packets", "packet_query"),
    ("traverse", "closest_hit_packets", "packet_query"),
    ("traverse", "_sort_rays", "packet_sort"),
    ("traverse", "_block_candidates", "packet_cull"),
    ("cuda_cull", "block_candidates", "packet_cull"),
    ("traverse", "pack_block_rays", "packet_pack"),
    # the stages' loop less the stage itself: the compaction between stages
    ("traverse", "_cascade_stages", "packet_compaction"),
    ("cuda_cascade", "cascade_stage", "cascade_stage"),
    ("traverse", "_unpermute_blocks", "packet_unpermute"),
    ("traverse", "_unsort", "packet_unsort"),
)
WAVES = ("closest_wave", "shadow_wave")


def _ranged(fn, label):
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)

    return wrapped


def wrap_steps() -> tuple:
    """Wraps every step of WRAPPED that the imported tree has in its
    profiler range. Returns (the wrapped "module.attr" names, a function
    that puts the originals back)."""
    import importlib

    undo, wrapped = [], []
    for modname, attr, label in WRAPPED:
        try:
            mod = importlib.import_module(f"path_tracer_ai_tpu_torch.accel."
                                          f"{modname}")
        except ModuleNotFoundError:
            continue
        if hasattr(mod, attr):
            fn = getattr(mod, attr)
            undo.append((mod, attr, fn))
            setattr(mod, attr, _ranged(fn, label))
            wrapped.append(f"{modname}.{attr}")

    def restore():
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)

    return wrapped, restore


def labels() -> set:
    """The profiler ranges' names: the steps' and the wave types'."""
    return {lab for _m, _a, lab in WRAPPED} | set(WAVES)


def _charge(events) -> dict:
    """label -> {kernel name -> [count, us]}: each kernel to the innermost
    labelled range above the op that launched it."""
    names = labels()
    out = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0, 0.0]))
    for ev in events:
        kernels = getattr(ev, "kernels", None)
        if not kernels:
            continue
        owner, p = "other", ev
        while p is not None:
            if p.name in names:
                owner = p.name
                break
            p = p.cpu_parent
        for k in kernels:
            slot = out[owner][k.name]
            slot[0] += 1
            slot[1] += float(k.duration)
    return out


def split_profile(prof) -> dict:
    """A profiled render's device time: kernels charged to the ranges
    (_charge), the port's own kernels by name (the profile's device time of
    each, less what was charged), and the sums."""
    charged = _charge(prof.events())
    names = labels()
    calls = collections.Counter(
        ev.name for ev in prof.events()
        if ev.name in names and not str(ev.device_type).endswith("CUDA"))
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
    by_name = collections.defaultdict(float)
    counts = collections.Counter()
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.key not in names:
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
    return {"device_kernel_seconds": (total_us + own_us) / 1e6,
            "charged_seconds": total_us / 1e6,
            "own_kernel_seconds": own_us / 1e6,
            "own_kernels": [{"name": n[:90], "count": c, "seconds": us / 1e6}
                            for n, (us, c) in sorted(
                                own.items(), key=lambda kv: -kv[1][0])],
            "ranges": ranges}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
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

    wrapped, _restore = wrap_steps()
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
    split = split_profile(prof)
    out = {"card": card, "tree": tree, "wrapped": wrapped,
           "timed_seconds": seconds, "image_sha256": sorted(set(images)),
           "host_reads": reads,
           "host_read_sites": sites,
           "busy_share": split["device_kernel_seconds"] / min(seconds),
           **split}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
