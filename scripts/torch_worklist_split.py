"""Splits the worklist route's device time by step, for a tree at a time.

    python3 scripts/torch_worklist_split.py [--tree DIR] [--reps N]
        [--kernels] [--route worklist|kslots|main|ctiles] [--out FILE]

DIR holds a checkout of the repository (for example a parent commit,
unpacked with `git archive`; default: this checkout); its
`path_tracer_ai_tpu_torch` is imported and its kernels are built in its own
`_build`. The worklist cell: blob subdiv 7 + room in clusters of 128
(327,688 triangles, 2,561 clusters in 161 supers: past 2048, so the
default routing takes the worklist backend and its 2-level cull),
1920x1080, 2 spp, 5 bounces, seed 0, waves of 2^20, blocks of 64, through
`wavefront.render`. --route kslots renders the kslots cell instead (blob
subdiv 6 + room in clusters of 128: 81,928 triangles, 641 clusters,
backend="kslots"), --route main the main path (the same scene, ctiles
closest waves on the clusters of 256, packet-cascade shadows), --route
ctiles the worklist cell through backend="ctiles" (both wave types; past
2048 clusters its 2-level cull: the eager `ctiles._block_candidates_2level`
where the tree runs it, else `cuda_ctiles.block_cull`): the same steps
where the route takes them (kslots and ctiles queries and culls, the
overflow fallbacks of both).

The steps of each worklist query (closest_hit_worklist, any_hit_worklist)
are timed with CUDA events around the tree's functions, the same in every
tree: the block sort (`worklist._prepare_blocks`), the cull (the eager
`worklist._cull_flat` / `_cull_2level` where the tree has them, else
`cuda_cull.worklist_cull` and its plain version), the build
(`worklist._build_worklist`: the cull and the item table; the table is
the build less the cull), the item sweep (`worklist._sweep_items`) and the
overflow fallback (`worklist._overflow_fallback`; inside it the pair
tiles' per-ray cull and table `pairs.build_pair_tables`, their sweep
`pairs._sweep_tiles` and the packet cascades on the whole wave
`pairs._whole_wave`); the rest of a query (resolve, unsort) is the query
less its sort, build, sweep and fallback. An event pair brackets a step
on the card's stream, so a step that the host cannot feed fast enough
counts its idle gaps too (as accel.worklist's stage_events do). After one
warm render, `reps` timed renders (synchronised; the steps and the host
reads by call site taken on the first). With --kernels, one more render
under torch.profiler (device activity only) counts its device kernels and
copies, with the profiled render's wall time. Prints one JSON line (and
appends it to FILE): the card's name and power limit, the tree, the timed
seconds, the image's sha256, the steps' device seconds by wave type, the
host reads by site, the launches of the worklist's kernels, of the pair
tables' and of ctiles' 2-level cull. Needs a GPU.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

# (module under path_tracer_ai_tpu_torch.accel, attribute, step); a tree
# that lacks one leaves it out
STEPS = (
    ("worklist", "closest_hit_worklist", "query"),
    ("worklist", "any_hit_worklist", "query"),
    ("kslots", "closest_hit_kslots", "query"),
    ("kslots", "any_hit_kslots", "query"),
    ("ctiles", "closest_hit_ctiles", "query"),
    ("ctiles", "any_hit_ctiles", "query"),
    ("ctiles", "_overflow_fallback", "fallback"),
    ("ctiles", "_block_candidates_2level", "cull"),
    ("cuda_ctiles", "block_cull", "cull"),
    ("worklist", "_prepare_blocks", "sort"),
    ("worklist", "_build_worklist", "build"),
    ("worklist", "_cull_flat", "cull"),
    ("worklist", "_cull_2level", "cull"),
    ("cuda_cull", "worklist_cull", "cull"),
    ("cuda_cull", "worklist_cull_plain", "cull"),
    ("worklist", "_sweep_items", "sweep"),
    ("worklist", "_overflow_fallback", "fallback"),
    # inside the fallback: the pair tiles' eager per-ray cull and table,
    # their sweep, and the packet cascades on the whole wave
    ("pairs", "build_pair_tables", "fallback_pair_tables"),
    ("pairs", "_sweep_tiles", "fallback_pair_sweep"),
    ("pairs", "_whole_wave", "fallback_whole_wave"),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--kernels", action="store_true")
    parser.add_argument("--route", default="worklist",
                        choices=("worklist", "kslots", "main", "ctiles"))
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

    events = {}  # (wave, step) -> [(start, end)]
    state = {"wave": None, "on": False}

    def timed_step(fn, step):
        def run(*a, **k):
            if step == "query":
                state["wave"] = ("closest" if fn.__name__.startswith(
                    "closest") else "shadow")
            if not state["on"]:
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.setdefault((state["wave"], step), []).append((start, end))
            return out

        run.__name__ = fn.__name__
        return run

    wrapped = []
    for modname, attr, step in STEPS:
        try:
            mod = importlib.import_module(
                f"path_tracer_ai_tpu_torch.accel.{modname}")
        except ModuleNotFoundError:
            continue
        if hasattr(mod, attr):
            setattr(mod, attr, timed_step(getattr(mod, attr), step))
            wrapped.append(f"{modname}.{attr}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.splitlines()[0].strip()
    scene = blob_scene(
        subdivisions=7 if args.route in ("worklist", "ctiles") else 6,
        device="cuda")
    accel = build_clusters(scene.triangles, cluster_size=128)
    cam = default_camera("cuda")
    settings = RenderSettings(width=1920, height=1080, samples_per_pixel=2,
                              max_bounces=5, seed=0)
    render_kw = {"worklist": dict(block_size=64),
                 "kslots": dict(backend="kslots"),
                 "ctiles": dict(backend="ctiles"),
                 "main": dict(accel_closest=build_clusters(
                     scene.triangles, cluster_size=256))}[args.route]
    backend = render_kw.get("backend") or (
        "hybrid" if args.route == "main"
        else wavefront.resolve_backend(accel, 64, False, None))
    images = []

    def render():
        return wavefront.render(scene, cam, settings, accel=accel,
                                wave_size=1 << 20, device="cuda",
                                **render_kw)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        images.append(hashlib.sha256(img.tobytes()).hexdigest())
        return time.perf_counter() - t0

    counters = []
    for modname, attr in (("cuda_cull", "worklist_launches"),
                          ("cuda_items", "launches"),
                          ("cuda_cull", "pair_launches"),
                          ("cuda_ctiles", "cull2_launches")):
        try:
            counters.append((importlib.import_module(
                f"path_tracer_ai_tpu_torch.accel.{modname}"), attr))
        except ModuleNotFoundError:
            pass

    def launches():
        return {f"{m.__name__.rsplit('.', 1)[1]}.{a}": getattr(m, a, None)
                for m, a in counters}

    timed()  # warm: builds the kernels
    sync.reset()
    before = launches()
    state["on"] = True
    seconds = [timed()]
    state["on"] = False
    after = launches()
    reads = sync.count
    sites = dict(sorted(sync.sites.items(), key=lambda kv: -kv[1]))
    torch.cuda.synchronize()
    steps = {}
    for (wave, step), ev in sorted(events.items()):
        steps.setdefault(wave, {})[step] = sum(
            a.elapsed_time(b) for a, b in ev) / 1e3
        steps[wave][f"{step}_calls"] = len(ev)
    for w in steps.values():
        if "build" in w:
            w["table"] = w["build"] - w.get("cull", 0.0)
        w["resolve_unsort"] = w.get("query", 0.0) - sum(
            w.get(k, 0.0) for k in ("sort", "build", "sweep", "fallback"))
    seconds += [timed() for _ in range(args.reps - 1)]
    out = {"card": card, "tree": tree, "route": args.route,
           "backend": backend,
           "clusters": accel.num_clusters, "supers": accel.num_supers,
           "wrapped": wrapped, "timed_seconds": seconds,
           "image_sha256": sorted(set(images)),
           "step_device_seconds": steps, "host_reads": reads,
           "host_read_sites": sites,
           "launches": {k: (after[k] - before[k]
                            if after[k] is not None else None)
                        for k in after}}
    if args.kernels:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
        out["device_kernels"] = int(sum(
            e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")))
        out["profiled_wall_seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
