"""A/B timing of item_sweep, kslot_sweep and the cascade stage kernel
across checkouts on one NVIDIA GPU.

    python3 scripts/torch_sweep_variants.py [--other NAME=DIR ...]
        [--sizes 128,2,16] [--sources item_sweep,kslot_sweep] [--reps N]
        [--out FILE]
    python3 scripts/torch_sweep_variants.py --sources cascade_stage \
        --other parent=DIR [--reps N] [--out FILE]

Builds, with the port's nvcc flags (cuda_build.NVCC_FLAGS), the sources
of the kernels of --sources of this checkout ("tree") and of each DIR given
with --other (its path_tracer_ai_tpu_torch/csrc, as it is: for example the
parent commit unpacked with `git archive`, or a copy of the tree with one
constant changed), one nvcc a library, all at once, and reads ptxas'
registers and spills and each instance's resident warps an SM.

cascade_stage (csrc/ctiles_sweep.cu's cascade_stage_kernel; not with the
other two): every stage of chip_smoke.py's kept cascades (the bench
render's two kept shadow calls and the worklist render's first kept
closest fallback; chip_smoke._stage_calls), each checkout's tuned entry
point on copies of the stage's inputs, the tree's at each W (1, 2, 4, 8;
its rule's named) and a checkout of the design before the split (an entry
point without W, "owned") as it is; each held against the host-stepped
loop (bit for bit carry, k and act) and timed in turns, every one and then
every one again in reverse order, the copy of the carry timed alone and
taken off.

Waves, for each cluster size S of --sizes and each kernel of --sources:
- kslot_sweep: chip_smoke.py's kernel-phase check waves (2^20 bounce-like
  rays on the blob scene of subdivision 6 in clusters of S, culled by
  kslots; closest K 12, shadow K 8);
- item_sweep: the inputs of its second closest and second shadow launch
  (wave 0, bounce 1) of a worklist render that runs its plain version (so
  that the waves do not depend on any checkout's kernel): at S = 128 the
  worklist scene (blob subdivision 7 + room) at the bench settings, the
  waves chip_smoke.py's item_waves phase keeps; at another S the blob of
  subdivision 6 at 480x270, where the default routing must take the
  worklist.

On each wave every library's tuned entry point (where one is compiled for
S) and generic one are called through ctypes on the same arguments, held
against the plain version (bitwise t, exact tri and occlusion;
"matches_plain"), and timed by CUDA events in turns: every one, then every
one again in reverse order. Prints one JSON line a (kernel, S, wave) and
the card's name and power limit; writes all of it to FILE (default
build/sweep_variants.json). Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("item_sweep", "kslot_sweep")
FILES = {"cascade_stage": "ctiles_sweep"}  # a kernel's csrc file, if not it
NO_INSTANCE = -1  # the entry points' answer for an S not compiled
ENTRY = re.compile(
    r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
    r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)


def build(checkouts: dict, sources, out_dir: str) -> dict:
    """{name: csrc dir} -> {(name, source): (CDLL, ptxas rows)}."""
    from path_tracer_ai_tpu_torch import cuda_build

    procs = {}
    for name, csrc in checkouts.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(csrc, f), d)
        for source in sources:
            so = os.path.join(d, source + ".so")
            procs[name, source] = (subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
                 os.path.join(d, FILES.get(source, source) + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so)
    out = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:  # reported, and left out of the timing
            print(json.dumps({"nvcc_failed": list(key), "log": log[-4000:]}),
                  flush=True)
            continue
        out[key] = (ctypes.CDLL(so), [
            {"entry": m[0], "registers": int(m[3]),
             "spill_bytes": int(m[1]) + int(m[2])}
            for m in ENTRY.findall(log)])
    return out


def entry(lib, source: str, generic: bool):
    fn = getattr(lib, source + ("_generic" if generic else ""))
    n_ptr, n_int = (8, 6) if source == "item_sweep" else (6, 5)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def runner(lib, source: str, generic: bool, args):
    """A call of the library's entry point on a kernel wrapper's arguments,
    into fresh outputs, as the wrapper makes them; None where the entry
    point has no instance for the shape."""
    import torch

    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import cuda_items, cuda_kslots

    fn = entry(lib, source, generic)
    want_tri = args[-1]
    dev = args[0].device
    if source == "item_sweep":
        pack, rays, item_block, ibase, order_g, n_cand, n_items, _ = args
        out = cuda_items._outputs(item_block.shape[0], 8, want_tri, dev)
        ptrs = [a.data_ptr() for a in (pack, rays, item_block, ibase,
                                       order_g, n_cand)]
        ints = [n_items, order_g.shape[1], 8, pack.shape[2], pack.shape[0],
                int(want_tri)]
    else:
        pack, rays, cid, n_slots, _ = args
        out = cuda_kslots._outputs(rays.shape[0], want_tri, dev)
        ptrs = [a.data_ptr() for a in (pack, rays, cid, n_slots)]
        ints = [rays.shape[0], cid.shape[1], pack.shape[2], pack.shape[0],
                int(want_tri)]
    ptrs += [out[0].data_ptr(), out[-1].data_ptr()]

    def call():
        err = cuda_build.launch(fn, dev, *ptrs, *ints)
        if err != 0:
            raise RuntimeError(f"{source} launch: cudaError {err}")
        return out

    if cuda_build.launch(fn, dev, *ptrs, *ints) == NO_INSTANCE:
        return None
    torch.cuda.synchronize()
    return call


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               if x.dtype == torch.float32 else torch.equal(x, y)
               for x, y in zip(a, b))


def compare(source, s, wave, args, libs, reps, card, info) -> dict:
    """Every library of `source`, tuned and generic entry, on one wave: its
    agreement with the plain version and its ms, timed in turns."""
    import chip_smoke
    from path_tracer_ai_tpu_torch.accel import cuda_items, cuda_kslots

    plain = (cuda_items.item_sweep_plain if source == "item_sweep"
             else cuda_kslots.kslot_sweep_plain)(*args)
    calls = {}
    for name, lib in libs.items():
        for generic in (False, True):
            call = runner(lib, source, generic, args)
            if call is not None:
                calls[f"{name}{' generic' if generic else ''}"] = (
                    call, same(call(), plain))
    times = {k: [] for k in calls}
    for order in (list(calls), list(reversed(calls))):
        for k in order:
            times[k].append(chip_smoke.cuda_ms(calls[k][0], reps))
    rows = {k: {"ms": sum(v) / len(v), "ms_runs": v,
                "matches_plain": calls[k][1]} for k, v in times.items()}
    res = {"source": source, "S": s, "wave": wave, "card": card, **info,
           "rows": rows}
    print(json.dumps(res), flush=True)
    return res


def stage_abi(csrc: str) -> str:
    """The cascade stage entry point's arguments in a checkout: "split" (W
    warps a slot, a work buffer) or "owned" (the design before it: no W,
    three 64-bit counters)."""
    with open(os.path.join(csrc, "ctiles_sweep.cu")) as fh:
        return "split" if "int any_hit, int w, void *stream" in fh.read() \
            else "owned"


def stage_runner(lib, abi: str, kept, w: int = 1):
    """A call of a library's tuned cascade_stage on copies of a kept
    stage's inputs (chip_smoke._keep_stages), as its wrapper makes them:
    (carry..., k, act)."""
    import torch

    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    (pack, rays, order_g, n_cand, carry, k, thr), kw = kept
    entry = kw.get("entry")
    fn = lib.cascade_stage
    split = abi == "split"
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (10 if split
                                                              else 9)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size, _, t_lanes = rays.shape
    _n, kgroups, g = order_g.shape
    c, _, s = pack.shape
    dev = rays.device
    ints = [size, kgroups, g, s, t_lanes, c,
            0 if entry is None else entry.shape[1], int(thr),
            int(entry is None)] + ([w] if split else [])

    def call():
        cs = tuple(x.clone() for x in carry)
        kk = k.clone()
        act = torch.empty((size,), dtype=torch.bool, device=dev)
        work = (cuda_cascade._work(size, dev)
                if split else torch.zeros((3,), dtype=torch.int64,
                                          device=dev))
        ptrs = ((0, cs[0].data_ptr(), 0, 0) if entry is None
                else (entry.data_ptr(), 0, cs[0].data_ptr(),
                      cs[1].data_ptr()))
        err = cuda_build.launch(fn, dev, pack.data_ptr(), rays.data_ptr(),
                                order_g.data_ptr(), n_cand.data_ptr(), *ptrs,
                                kk.data_ptr(), act.data_ptr(),
                                work.data_ptr(), *ints)
        if err != 0:
            raise RuntimeError(f"cascade_stage ({abi}): cudaError {err}")
        return (*cs, kk, act)

    return call


def compare_stages(libs: dict, reps: int, card) -> list:
    """cascade_stage (see the module) on every stage of chip_smoke's kept
    cascades: a line a cascade."""
    from functools import partial

    import chip_smoke
    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=6, device="cuda")
    accel_base = build_clusters(scene.triangles, cluster_size=128)
    accel_c = build_clusters(scene.triangles, cluster_size=256)
    kept_shadows = chip_smoke._keep_shadow_calls(scene, accel_base, accel_c)
    chip_smoke.phase_item_waves(*chip_smoke.worklist_scene(), card)
    out = []
    for label, fn, call in chip_smoke._stage_calls(kept_shadows):
        rows = []
        for kept in chip_smoke._keep_stages(fn, *call):
            (pack, rays, _og, _nc, carry, k, _thr), kw = kept
            want = chip_smoke._stage_run(kept, partial(
                cuda_cascade.cascade_stage_plain,
                sweep=cuda_ctiles.tile_sweep))
            calls = {}
            for name, (lib, abi) in libs.items():
                for w in (1, 2, 4, 8) if abi == "split" else (None,):
                    calls[name + (f" w{w}" if w else "")] = stage_runner(
                        lib, abi, kept, w or 1)
            copy_ms = chip_smoke.cuda_ms(
                lambda: tuple(c.clone() for c in carry) + (k.clone(),), reps)
            times = {n: [] for n in calls}
            same = {n: chip_smoke._same_outputs(f(), want)
                    for n, f in calls.items()}
            for order in (list(calls), list(reversed(calls))):
                for n in order:
                    times[n].append(chip_smoke.cuda_ms(calls[n], reps)
                                    - copy_ms)
            rows.append({
                "size": rays.shape[0], "k_in": int(k), "k_out": int(want[-2]),
                "rule_w": chip_smoke._rule_w(rays, pack, not kw),
                "ms": {n: sum(v) / len(v) for n, v in times.items()},
                "ms_runs": times, "matches_host_stepped": same})
        res = {"source": "cascade_stage", "call": label, "card": card,
               "stages": rows}
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


class _Kept(Exception):
    """Both waves are kept: the render need not go on."""


def item_waves(scene, accel, settings) -> list:
    """The arguments of item_sweep's second closest and second shadow
    launch (wave 0, bounce 1) of a render of `scene` with the default
    routing, which must be the worklist; item_sweep's plain version runs,
    and the render stops once both are kept."""
    import torch

    from path_tracer_ai_tpu_torch.accel import cuda_items
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    backend = wavefront.resolve_backend(accel, 64, False, None)
    if backend != "worklist":
        raise SystemExit(f"default routing picked {backend!r}")
    kept = {True: [], False: []}
    real = cuda_items.item_sweep

    def keep(*a):
        if len(kept[a[-1]]) < 2:
            kept[a[-1]].append(tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in a))
        out = cuda_items.item_sweep_plain(*a)
        if min(len(v) for v in kept.values()) == 2:
            raise _Kept
        return out

    cuda_items.item_sweep = keep
    try:
        wavefront.render(scene, default_camera("cuda"), settings,
                         accel=accel, wave_size=1 << 20, block_size=64,
                         device="cuda")
    except _Kept:
        pass
    finally:
        cuda_items.item_sweep = real
    return [kept[True][1], kept[False][1]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=DIR",
                        help="a checkout to build and time beside the tree")
    parser.add_argument("--sizes", default="128,2,16")
    parser.add_argument("--sources", default=",".join(SOURCES))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default=os.path.join(
        ROOT, "build", "sweep_variants.json"))
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import cuda_items
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    card = chip_smoke.phase_device()
    checkouts = {"tree": cuda_build.CSRC_DIR}
    for item in args.other:
        name, _, d = item.partition("=")
        checkouts[name] = os.path.join(os.path.abspath(d),
                                       "path_tracer_ai_tpu_torch", "csrc")
    sizes = [int(x) for x in args.sizes.split(",")]
    sources = args.sources.split(",")
    built = build(checkouts, sources,
                  os.path.join(ROOT, "build", "sweep_variants"))
    if sources == ["cascade_stage"]:
        libs = {name: (lib, stage_abi(checkouts[name]))
                for (name, _src), (lib, _) in built.items()}
        report = {"card": card, "ptxas": {
            f"{n} {s}": v[1] for (n, s), v in built.items()},
            "abi": {n: abi for n, (_lib, abi) in libs.items()},
            "calls": compare_stages(libs, args.reps, card)}
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        return 0
    if "cascade_stage" in sources:
        parser.error("cascade_stage runs alone (--sources cascade_stage)")

    def occupancy_of(lib, source, s, closest):
        try:  # an S with no instance is refused (S = 0 too, in
            # a checkout whose entry point knows no generic instance)
            return cuda_items.read_occupancy(
                getattr(lib, source + "_occupancy"), s, int(closest))
        except RuntimeError:
            return None

    occupancy = {
        f"{name} {source}": {
            f"S {s or 'generic'} {w}": occupancy_of(lib, source, s,
                                                    w == "closest")
            for s in sorted({*sizes, 0}) for w in ("closest", "anyhit")}
        for (name, source), (lib, _) in built.items()}
    report = {"card": card,
              "ptxas": {f"{n} {s}": v[1] for (n, s), v in built.items()},
              "occupancy": occupancy, "waves": []}
    print(json.dumps({k: report[k] for k in ("card", "ptxas",
                                               "occupancy")}), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def waves(source, s, named_args):
        libs = {n: lib for (n, src), (lib, _) in built.items()
                if src == source}
        for wave, wargs, info in named_args:
            reps = args.reps if source == "kslot_sweep" else max(
                args.reps // 2, 3)
            report["waves"].append(compare(source, s, wave, wargs, libs,
                                           reps, card, info))
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=1)

    blob = blob_scene(subdivisions=6, device="cuda")
    for s in sizes:
        accel = build_clusters(blob.triangles, cluster_size=s)
        if "kslot_sweep" in sources:
            rng = np.random.default_rng(3)
            named = []
            for shadow in (False, True):
                kargs, info = chip_smoke.kslot_check_args(accel, rng, shadow)
                named.append(("shadow" if shadow else "closest", kargs, info))
            waves("kslot_sweep", s, named)
        if "item_sweep" not in sources:
            continue
        if s == 128:
            scene_w, accel_w = chip_smoke.worklist_scene()
            settings = RenderSettings(**chip_smoke.BENCH)
        else:
            scene_w, accel_w = blob, accel
            settings = RenderSettings(**{**chip_smoke.BENCH, "width": 480,
                                         "height": 270})
        item_args = item_waves(scene_w, accel_w, settings)
        waves("item_sweep", s, [
            (f"{w}, wave 0, bounce 1", a,
             {"items": a[6], "clusters": accel_w.num_clusters})
            for w, a in zip(("closest", "shadow"), item_args)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
