"""A/B timing of variants of the packet cascades' interval cull
(csrc/packet_cull.cu) on one NVIDIA GPU, in turns.

    python3 scripts/torch_cull_variants.py --dir DIR [--reps N]
        [--out FILE]

DIR holds variants of csrc/packet_cull.cu (`<name>.cu`, each a copy of
the source with one change, keeping its C entry point `packet_cull`).
Each is built with the port's nvcc flags (cuda_build.NVCC_FLAGS), one nvcc
a library, all at once; ptxas' register line is printed. The inputs are
chip_smoke.py's: the main path's two kept shadow calls (wave 0, bounces 0
and 1: 65,536 blocks of 64, C 641, no entries), a packets-route closest
call (2^20 bounce rays in blocks of 256, t_max +inf, entries) and the
worklist accel's C 2,561 (2^20 shadow rays, blocks of 64). Every variant
is held against the plain version (cuda_cull.block_candidates_plain) on
each input, then timed (CUDA events, `reps` launches) on each, every
variant and then every variant again in reverse order. Prints one JSON
line (and writes it to FILE): the card, and per variant whether it
agreed on each input and its two ms on each. Needs a GPU.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dir", required=True)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import cuda_cull
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    names = sorted(f[:-3] for f in os.listdir(args.dir) if f.endswith(".cu"))
    procs = {n: subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
         os.path.join(args.dir, n + ".so"), os.path.join(args.dir, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {n}:\n{log}", file=sys.stderr)
            return 1
        print(n, [ln for ln in log.splitlines() if "registers" in ln])
        fn = ctypes.CDLL(os.path.abspath(
            os.path.join(args.dir, n + ".so"))).packet_cull
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        libs[n] = fn

    card = c.phase_device()
    scene = blob_scene(subdivisions=6, device="cuda")
    accel = build_clusters(scene.triangles, cluster_size=128)
    accel_c = build_clusters(scene.triangles, cluster_size=256)
    kept = c._keep_shadow_calls(scene, accel, accel_c)
    rng = np.random.default_rng(20)
    inputs = [("shadow b0", c._shadow_cull_inputs(kept[0]), False),
              ("shadow b1", c._shadow_cull_inputs(kept[1]), False)]
    o, d, tm = c._bounce_wave(accel, 1 << 20, rng, shadow=False)
    inputs.append(("closest R256", c._cull_inputs(accel, o, d, tm, 256,
                                                  True), True))
    _scene_w, accel_w = c.worklist_scene()
    o, d, tm = c._bounce_wave(accel_w, 1 << 20, rng, shadow=True)
    inputs.append(("worklist C2561", c._cull_inputs(accel_w, o, d, tm, 64,
                                                    True), False))

    def run(name, inp, with_entry):
        acc, ob, db, tb = inp
        nb, r = ob.shape[:2]
        cc = acc.num_clusters
        order = torch.empty((nb, cc), dtype=torch.int32, device="cuda")
        n_cand = torch.empty((nb,), dtype=torch.int32, device="cuda")
        entry = (torch.empty((nb, cc), device="cuda") if with_entry
                 else None)
        err = cuda_build.launch(
            libs[name], ob.device, ob.data_ptr(), db.data_ptr(),
            tb.data_ptr(), acc.bmin.data_ptr(), acc.bmax.data_ptr(), nb, r,
            cc, order.data_ptr(), n_cand.data_ptr(),
            None if entry is None else entry.data_ptr(), None)
        if err != 0:
            raise RuntimeError(f"{name}: cudaError {err}")
        return order, n_cand, entry

    res = {n: {"matches_plain": []} for n in names}
    for _label, inp, with_entry in inputs:
        want = cuda_cull.block_candidates_plain(*inp, with_entry)
        for n in names:
            got = run(n, inp, with_entry)
            torch.cuda.synchronize()
            res[n]["matches_plain"].append(c._same_cull(got, want))
    for n in names + names[::-1]:
        for label, inp, with_entry in inputs:
            res[n].setdefault(label, []).append(c.cuda_ms(
                lambda: run(n, inp, with_entry), args.reps))
    line = json.dumps({"card": card, "variants": res})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
