"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device       CUDA must be available; the card's name and power limit.
  2. build        nvcc builds every kernel of the main path from csrc/.
  3. kernel       each kernel against its plain PyTorch version on the card,
                  at the main path's shapes (bitwise t, exact tri).
  4. main_path    the benchmark render (blob subdiv 6 + room, 1920x1080,
                  2 spp, 5 bounces, seed 0, waves of 2^20, blocks of 64)
                  through path_tracer_ai_tpu_torch.engine.wavefront.render:
                  a warm pass, then a timed pass with the launch counts
                  zeroed just before it and read just after.
  4b. profile     one more such render under torch.profiler: device kernel
                  time by kernel and by wave type, and the device's busy
                  share of the timed pass.
  5. consistency  wavefront vs oracle on the card (96x54, 4 spp, 5 bounces,
                  blob subdiv 4): must agree bitwise.
Then the kernels line, and last {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations of one Möller–Trumbore test as the kernel writes it
# (h: 9, a: 5, f: 1 division, s: 3, u: 6, q: 9, v: 6, t: 6, u+v: 1).
MT_OPS = 46


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    print(json.dumps({"phase": phase, "ok": False, "error": msg}),
          file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build():
    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    t0 = time.perf_counter()
    built = cuda_build.build_all([cuda_ctiles.SOURCE])
    ptxas = {k: v["ptxas"].strip().splitlines()[-2:]
             for k, v in cuda_build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "ptxas": ptxas})


def _tile_rays(accel, nt, t_lanes, rng, dead_every=7):
    """Bounce-like tiles: tile i's rays leave points near the triangles of
    cluster cid[i] in random directions (bench.py's exactness wave), t_max
    inf, with every `dead_every`-th lane dead (t_max = -1)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    dev = accel.v0.device
    c, s = accel.num_clusters, accel.cluster_size
    cid = rng.integers(0, c, nt).astype(np.int32)
    v0 = accel.v0.cpu().numpy()
    slot = rng.integers(0, s, (nt, t_lanes))
    o = v0[cid[:, None], slot].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-3
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(o.shape[0], np.inf, np.float32)
    tm[::dead_every] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm), t_lanes)
    return rays, t(cid)


def _check_tile_sweep(accel, t_lanes, nt, rng, reps):
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    pack = cuda_ctiles.pack_tris(accel)
    rays, cid = _tile_rays(accel, nt, t_lanes, rng)
    t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid)
    t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, cid)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)))
    tri_eq = bool(torch.equal(tri_k, tri_p))
    fin = torch.isfinite(t_k) & torch.isfinite(t_p)
    err = float((t_k[fin] - t_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    hits = int((tri_k != cuda_ctiles.I32_MAX).sum())
    ms = cuda_ms(lambda: cuda_ctiles.tile_sweep(pack, rays, cid), reps)
    plain_ms = cuda_ms(lambda: cuda_ctiles.tile_sweep_plain(pack, rays, cid), 2)
    s = accel.cluster_size
    n_used = int(torch.unique(cid).numel())
    nbytes = (n_used * 10 * s * 4 + rays.numel() * 4 + cid.numel() * 4
              + 2 * nt * t_lanes * 4)
    ops = nt * t_lanes * s * MT_OPS
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S > ops / PEAK_F32_PER_S \
        else "operations"
    res = {"phase": "kernel", "name": "tile_sweep", "T": t_lanes, "S": s,
           "nt": nt, "t_bitwise": bitwise, "tri_equal": tri_eq,
           "max_abs_err": err, "hit_lanes": hits, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "gtests_per_s": nt * t_lanes * s / ms / 1e6}
    emit(res)
    if not (bitwise and tri_eq):
        fail("kernel", f"tile_sweep T={t_lanes} disagrees with its plain version")
    if hits == 0:
        fail("kernel", f"tile_sweep T={t_lanes} check wave hit nothing")
    return res


def phase_kernels(accel_base, accel_c):
    rng = np.random.default_rng(0)
    main = _check_tile_sweep(accel_c, 128, 2048, rng, reps=20)  # closest path
    shadow = _check_tile_sweep(accel_base, 64, 2048, rng, reps=20)  # cascade
    return main, shadow


def phase_main_path(scene, accel_base, accel_c, card):
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.io.image import save_image
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.utils import sync

    settings = RenderSettings(width=1920, height=1080, samples_per_pixel=2,
                              max_bounces=5, seed=0)
    cam = default_camera("cuda")
    kw = dict(accel=accel_base, accel_closest=accel_c, wave_size=1 << 20,
              device="cuda")
    t0 = time.perf_counter()
    wavefront.render(scene, cam, settings, **kw)  # warm pass
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    cuda_ctiles.reset_launches()
    sync.reset()
    stats = wavefront.RenderStats()
    img = wavefront.render(scene, cam, settings, stats=stats, **kw)
    launches = cuda_ctiles.launches
    syncs = sync.count

    finite = bool(np.isfinite(img).all())
    magenta = float(np.all(img == np.asarray([1.0, 0.0, 1.0], np.float32),
                           axis=-1).mean())
    nonblack = float((img.max(axis=-1) > 0).mean())
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_bench.png")
    save_image(png, img, settings.gamma)
    res = {"phase": "main_path", "card": card, "warm_seconds": warm_s,
           "seconds": stats.seconds, "closest_rays": stats.closest_rays,
           "shadow_rays": stats.shadow_rays, "mrays_per_s": stats.mrays_per_s,
           "tile_sweep_launches": launches, "host_syncs": syncs,
           "finite": finite, "magenta_share": magenta,
           "nonblack_share": nonblack, "image_mean": float(img.mean()),
           "png": png}
    emit(res)
    if launches <= 0:
        fail("main_path", "the render launched no tile_sweep kernel")
    if not finite or magenta > 0.0 or nonblack < 0.5:
        fail("main_path", "bad image (non-finite, magenta or mostly black)")
    return res


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _range_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(scene, accel_base, accel_c, timed_seconds):
    """One more bench render under torch.profiler: device kernel time by
    name and by wave type. The busy share divides the device time by the
    UNPROFILED timed pass's wall time (profiling slows the host, not the
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    settings = RenderSettings(width=1920, height=1080, samples_per_pixel=2,
                              max_bounces=5, seed=0)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wavefront.render(scene, default_camera("cuda"), settings,
                         accel=accel_base, accel_closest=accel_c,
                         wave_size=1 << 20, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    labels = ("closest_wave", "shadow_wave")
    # Device-side entries are kernels and copies; the labelled ranges also
    # appear there (as spans, gaps included) and are reported apart.
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")
               and e.key not in labels]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    host = [e for e in avgs
            if e.key in labels and not str(e.device_type).endswith("CUDA")]
    ranges = {e.key: _range_us(e) / 1e6 for e in host}
    # host wall inside each label, syncs included (inflated by profiling)
    host_s = {e.key: float(e.cpu_time_total) / 1e6 for e in host}
    res = {"phase": "profile", "profiled_wall_seconds": wall,
           "device_kernel_seconds": busy_us / 1e6,
           "device_kernels": int(sum(e.count for e in kernels)),
           "busy_share_of_timed_pass": (busy_us / 1e6 / timed_seconds
                                        if busy_us else "not measured"),
           "wave_kernel_seconds": ranges,
           "wave_profiled_host_seconds": host_s,
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "seconds": _device_us(e) / 1e6} for e in top]}
    emit(res)
    return res


def phase_consistency():
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=4, device="cuda")
    settings = RenderSettings(width=96, height=54, samples_per_pixel=4,
                              max_bounces=5, seed=0)
    cam = default_camera("cuda")
    t0 = time.perf_counter()
    img_w = wavefront.render(scene, cam, settings, wave_size=1 << 14,
                             device="cuda")
    img_o = oracle.render(scene, cam, settings, device="cuda")
    diff = float(np.abs(img_w - img_o).max())
    res = {"phase": "consistency", "max_abs_diff": diff,
           "bitwise": bool(np.array_equal(img_w, img_o)),
           "image_mean": float(img_o.mean()),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if diff != 0.0:  # tests/test_torch_render.py holds this pair bitwise
        fail("consistency", f"wavefront and oracle differ by {diff}")


def main() -> int:
    t_start = time.perf_counter()
    import path_tracer_ai_tpu_torch  # noqa: F401  (fails outside the repo)

    card = phase_device()
    phase_build()

    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    t0 = time.perf_counter()
    scene = blob_scene(subdivisions=6, device="cuda")
    accel_base = build_clusters(scene.triangles, cluster_size=128)
    accel_c = build_clusters(scene.triangles, cluster_size=256)
    emit({"phase": "scene", "triangles": scene.triangles.count,
          "clusters_s128": accel_base.num_clusters,
          "clusters_s256": accel_c.num_clusters,
          "seconds": time.perf_counter() - t0})

    main_k, _shadow_k = phase_kernels(accel_base, accel_c)
    render = phase_main_path(scene, accel_base, accel_c, card)
    phase_profile(scene, accel_base, accel_c, render["seconds"])
    phase_consistency()

    emit({"kernels": [{
        "name": "tile_sweep", "route": "cuda",
        "source": "path_tracer_ai_tpu_torch/csrc/ctiles_sweep.cu",
        "replaces": "path_tracer_ai_tpu/accel/pallas_ctiles.py:239",
        "launches": render["tile_sweep_launches"],
        "matches_plain": True,
        "max_abs_err": main_k["max_abs_err"], "ms": main_k["ms"],
        "plain_ms": main_k["plain_ms"], "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"], "library_ms": None,
    }], "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
