"""Multi-device rendering over a (tiles, samples) mesh of devices
(counterpart of parallel/mesh.py).

- axis "tiles": the frame's pixels are split into one block per tile row;
  the scene, the accels and the traversal packs are copied once to each
  distinct device.
- axis "samples": samples per pixel are strided over the row's devices
  (device s renders samples s, s + n_samp, ...); the reference's psum over
  "samples" is a sum, in ascending sample order, of the row's partial
  sums moved to the row's first device.

The RNG streams are keyed by (pixel, global sample), so every mesh shape
traces the same samples as one device; images agree up to the order of
the f32 sums (bitwise at 2 spp, where each pixel sums two values).

One process drives every device, as the reference's single controller
drives its mesh: a Mesh is an [n_tile, n_samp] array of torch.device
entries. On cuda the default is every visible card; one card may stand
several times in a mesh (a virtual mesh). Each shard's work runs with its
card as the current device (_on), as the kernels' launches need. The
shards of a bounce are issued one after another, and each one's shadow
cascade reads live counts on the host before the next shard is issued,
so shards on distinct cards overlap little. With device="cpu", render_tiled builds a mesh of CPU_DEVICES
virtual CPU entries (the counterpart of the reference tests' virtual host
devices). The reference's executable cache (_mexe, clear_mesh_caches) has
no counterpart: eager torch compiles nothing to cache.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel, build_clusters
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core import threefry
from path_tracer_ai_tpu_torch.core.types import SceneData
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.engine import tracer, wavefront
from path_tracer_ai_tpu_torch.engine.oracle import finish_image
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt_io
from path_tracer_ai_tpu_torch.scene.camera import Camera
from path_tracer_ai_tpu_torch.scene.scene import scene_to
from path_tracer_ai_tpu_torch.utils import sync
from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Entries of the CPU mesh that render_tiled builds for device="cpu".
CPU_DEVICES = 8
# Pixels a shard traces at once: the wave scheduler's wave (the reference:
# 2^16). A host-stepped bounce costs about the same host reads at any
# width (a shadow cascade runs as many iterations as its worst block
# needs), so on an H100 the reference's 2^16 made a virtual mesh of the
# 1080p bench render over 10x slower than the wave scheduler (PERF.md
# section 5). The chunk changes no image.
PIX_CHUNK = 1 << 20


class Mesh:
    """An [n_tile, n_samp] array of devices with the reference's axis names."""

    def __init__(self, devices):
        self.devices = tuple(tuple(row) for row in devices)

    @property
    def shape(self) -> dict:
        return {"tiles": len(self.devices), "samples": len(self.devices[0])}


def _on(dev):
    """`dev` as the current device (a card), or no change (the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def available_devices(device=None) -> list:
    """Every visible card (device None or cuda; RuntimeError without one),
    or CPU_DEVICES virtual entries of the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * CPU_DEVICES


def make_mesh(n_tile: int, n_sample: int = 1, devices=None) -> Mesh:
    """The first n_tile * n_sample of `devices` (None: every visible card)
    as an [n_tile, n_sample] mesh; ValueError if there are fewer."""
    devs = list(devices) if devices is not None else available_devices()
    need = n_tile * n_sample
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    devs = [_canonical(d) for d in devs[:need]]
    return Mesh([devs[t * n_sample:(t + 1) * n_sample]
                 for t in range(n_tile)])


class _Replicas:
    """The scene, camera, base key and traversal backend, built once per
    distinct device of a mesh."""

    def __init__(self, scene, camera, seed, make_backend):
        self.scene, self.camera, self.seed = scene, camera, seed
        self.make_backend = make_backend
        self.by_device = {}

    def get(self, dev) -> SimpleNamespace:
        if dev not in self.by_device:
            with _on(dev):
                self.by_device[dev] = SimpleNamespace(
                    scene=scene_to(self.scene, dev),
                    camera=self.camera.to(dev),
                    base_key=threefry.key(self.seed, device=dev),
                    backend=self.make_backend(dev))
        return self.by_device[dev]


def _layout(mesh: Mesh, settings: RenderSettings, block_size: int,
            pix_chunk: int):
    """The reference's per-tile pixel blocks: p_loc pixels a tile (padded
    to whole chunks of `chunk` lanes, a multiple of block_size), and the
    pixel coordinates [n_tile, p_loc] (padding replays pixel 0)."""
    w, h = settings.width, settings.height
    n_tile = mesh.shape["tiles"]
    npix = w * h
    p_loc = -(-npix // n_tile)
    chunk = min(pix_chunk, p_loc)
    chunk = -(-chunk // block_size) * block_size
    p_loc = -(-p_loc // chunk) * chunk
    pix = torch.arange(n_tile * p_loc, dtype=torch.int64)
    pix = torch.where(pix < npix, pix, 0)
    return p_loc, chunk, (pix % w).reshape(n_tile, p_loc), \
        (pix // w).reshape(n_tile, p_loc)


def _psum(parts, dev):
    """The reference's psum over "samples": the row's partial sums, in
    ascending sample order, on the row's first device."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part.to(dev)
    return out


def render_sharded(scene: SceneData, camera: Camera,
                   settings: RenderSettings, mesh: Mesh,
                   accel: Optional[ClusterAccel] = None,
                   block_size: int = 256, pix_chunk: int = PIX_CHUNK
                   ) -> np.ndarray:
    """Pixels sharded over "tiles", samples over "samples"; each shard
    traces whole paths (tracer.trace_paths: every bounce of a chunk at full
    width, no compaction) on the default backend."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    aspect = settings.aspect_ratio()
    n_samp = mesh.shape["samples"]
    if accel is None:
        accel = build_clusters(scene.triangles, device=mesh.devices[0][0])
    seed = settings.seed if settings.seed is not None else 0
    reps = _Replicas(scene, camera, seed, lambda dev: wavefront.packet_backend(
        accel.to(dev), block_size))
    npix = w * h
    p_loc, chunk, xs_all, ys_all = _layout(mesh, settings, block_size,
                                           pix_chunk)
    spp_loc = -(-spp // n_samp)
    acc = [torch.zeros((p_loc, 3), dtype=torch.float32, device=row[0])
           for row in mesh.devices]
    cnt = [torch.zeros((p_loc,), dtype=torch.int32, device=row[0])
           for row in mesh.devices]
    for lo in range(0, p_loc, chunk):
        for ti, row in enumerate(mesh.devices):
            accs, cnts = [], []
            for si, dev in enumerate(row):
                r = reps.get(dev)
                with _on(dev):
                    xs = xs_all[ti, lo:lo + chunk].to(dev)
                    ys = ys_all[ti, lo:lo + chunk].to(dev)
                    a = torch.zeros((chunk, 3), dtype=torch.float32,
                                    device=dev)
                    c = torch.zeros((chunk,), dtype=torch.int32, device=dev)
                    for j in range(spp_loc):
                        s = si + j * n_samp  # global sample index
                        o, d, keys, _ = wavefront._wave_gen(
                            r.camera, r.base_key, xs, ys, s, w=w, h=h, sc=1,
                            lanes_padded=chunk, aspect=aspect)
                        radiance, valid, _ = tracer.trace_paths(
                            r.scene, o, d, keys, settings.max_bounces,
                            *r.backend, rr_start=settings.rr_start)
                        valid = valid & (s < spp)  # the strided tail past spp
                        a = a + torch.where(valid[:, None], radiance, 0.0)
                        c = c + valid.to(torch.int32)
                accs.append(a)
                cnts.append(c)
            with _on(row[0]):
                acc[ti][lo:lo + chunk] = _psum(accs, row[0])
                cnt[ti][lo:lo + chunk] = _psum(cnts, row[0])
    acc_h = torch.cat([a.cpu() for a in acc]).numpy()[:npix]
    cnt_h = torch.cat([c.cpu() for c in cnt]).numpy()[:npix]
    return finish_image(acc_h, cnt_h, w, h)


def render_sharded_wavefront(
        scene: SceneData, camera: Camera, settings: RenderSettings,
        mesh: Mesh, accel: Optional[ClusterAccel] = None,
        block_size: int = 64, pix_chunk: int = PIX_CHUNK,
        backend: Optional[str] = None, checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0, stats=None,
        compact_min_bucket: int = 1 << 14,
        accel_closest: Optional[ClusterAccel] = None) -> np.ndarray:
    """The host-stepped wave scheduler over a mesh: each shard's wave state
    lives on its device, and each bounce is issued for every shard, one
    after another, before the live counts that size the next compaction
    are read (the shadow cascade of each shard's bounce reads its own live
    counts first). The compaction bucket comes from the largest per-shard
    live count, so all shards keep one width. Checkpoints are per pass (n_samp samples); a
    checkpoint whose sample count the samples axis does not divide cannot
    resume here (ValueError)."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    aspect = settings.aspect_ratio()
    n_tile, n_samp = mesh.shape["tiles"], mesh.shape["samples"]
    dev0 = mesh.devices[0][0]
    if accel is None:
        accel = build_clusters(scene.triangles, device=dev0)
    seed = settings.seed if settings.seed is not None else 0

    def backend_on(dev):
        acc_c = accel_closest.to(dev) if accel_closest is not None else None
        return wavefront.packet_backend(accel.to(dev), block_size,
                                        backend=backend, accel_closest=acc_c,
                                        packs={})

    reps = _Replicas(scene, camera, seed, backend_on)
    npix = w * h
    p_loc, chunk, xs_all, ys_all = _layout(mesh, settings, block_size,
                                           pix_chunk)
    spp_loc = -(-spp // n_samp)

    acc_h = np.zeros((npix, 3), np.float32)
    cnt_h = np.zeros((npix,), np.int32)
    fingerprint = ckpt_io.fingerprint(settings, scene.triangles.count, seed)
    j_start = 0
    if checkpoint_path:
        loaded = ckpt_io.load(checkpoint_path, fingerprint)
        if loaded is not None:
            acc_h, cnt_h, s_done = loaded
            if s_done % n_samp != 0:
                # Flooring j_start would render the partial pass's samples
                # again and count them twice.
                raise ValueError(
                    f"checkpoint at {s_done} samples is not a multiple of "
                    f"the mesh's samples axis ({n_samp}); resume it on a "
                    f"mesh whose samples axis divides {s_done}, or finish "
                    "the pass on the scheduler that wrote it")
            j_start = s_done // n_samp
            log.info("Resuming sharded render at sample %d/%d", s_done, spp)

    def to_tiles(x):
        out = np.zeros((n_tile * p_loc,) + x.shape[1:], x.dtype)
        out[:npix] = x
        out = out.reshape((n_tile, p_loc) + x.shape[1:])
        return [torch.as_tensor(out[t], device=row[0])
                for t, row in enumerate(mesh.devices)]

    acc, cnt = to_tiles(acc_h), to_tiles(cnt_h)

    def pull():
        return (torch.cat([a.cpu() for a in acc]).numpy()[:npix],
                torch.cat([c.cpu() for c in cnt]).numpy()[:npix])

    shards = [(ti, si, dev) for ti, row in enumerate(mesh.devices)
              for si, dev in enumerate(row)]
    t_start = time.perf_counter()
    passes_done = 0
    for j in range(j_start, spp_loc):
        for lo in range(0, p_loc, chunk):
            lanes = []
            for ti, si, dev in shards:
                r = reps.get(dev)
                s = j * n_samp + si  # global sample index
                with _on(dev):
                    o, d, keys, _ = wavefront._wave_gen(
                        r.camera, r.base_key,
                        xs_all[ti, lo:lo + chunk].to(dev),
                        ys_all[ti, lo:lo + chunk].to(dev), s, w=w, h=h, sc=1,
                        lanes_padded=chunk, aspect=aspect)
                    # the strided tail past spp renders dead
                    alive = torch.full((chunk,), s < spp, dtype=torch.bool,
                                       device=dev)
                    lanes.append(wavefront._Lanes(o, d, keys, alive))
            for depth in range(settings.max_bounces):
                if depth > 0:
                    counts = [ln.alive.sum() for ln in lanes]
                    n_live = [sync.host_int(c) for c in counts]
                    bucket = wavefront._compact_bucket(max(n_live),
                                                       compact_min_bucket)
                    if max(n_live) > 0 and bucket <= lanes[0].width // 2:
                        for ln, n, (_ti, _si, dev) in zip(lanes, n_live,
                                                          shards):
                            with _on(dev):
                                ln.compact(n, bucket)
                for ln, (_ti, _si, dev) in zip(lanes, shards):
                    r = reps.get(dev)
                    with _on(dev):
                        ln.step(r.scene, r.backend, depth, settings.rr_start)
            parts = {}
            for ln, (ti, si, dev) in zip(lanes, shards):
                s = j * n_samp + si
                with _on(dev):
                    rad = ln.final_radiance()
                    valid = torch.isfinite(rad).all(dim=-1) & (s < spp)
                    parts.setdefault(ti, []).append(
                        (torch.where(valid[:, None], rad, 0.0),
                         valid.to(torch.int32)))
            for ti, row in enumerate(mesh.devices):
                with _on(row[0]):
                    a = _psum([p[0] for p in parts[ti]], row[0])
                    c = _psum([p[1] for p in parts[ti]], row[0])
                    acc[ti][lo:lo + chunk] = acc[ti][lo:lo + chunk] + a
                    cnt[ti][lo:lo + chunk] = cnt[ti][lo:lo + chunk] + c
            if stats is not None:
                stats.closest_rays += sum(sync.host_int(ln.nc)
                                          for ln in lanes)
                stats.shadow_rays += sum(sync.host_int(ln.ns)
                                         for ln in lanes)
        passes_done += 1
        if checkpoint_path and (
                (checkpoint_every and passes_done % checkpoint_every == 0)
                or j + 1 >= spp_loc):
            ckpt_io.save(checkpoint_path, *pull(), (j + 1) * n_samp,
                         fingerprint)
    acc_h, cnt_h = pull()
    if stats is not None:
        stats.seconds += time.perf_counter() - t_start
    return finish_image(acc_h, cnt_h, w, h)


def render_tiled(scene: SceneData, camera: Camera, settings: RenderSettings,
                 n_devices: Optional[int] = None, scheduler: str = "wave",
                 device=None, **kw) -> np.ndarray:
    """Tile sharding over the first n_devices of available_devices(device)
    (capped at their count). scheduler "wave": render_sharded_wavefront;
    "fused": render_sharded, which refuses the wave scheduler's options."""
    avail = available_devices(device)
    n = min(n_devices or len(avail), len(avail))
    mesh = make_mesh(n, 1, devices=avail)
    log.info("Rendering on %d-device mesh (tiles=%d, samples=1)", n, n)
    if scheduler == "wave":
        return render_sharded_wavefront(scene, camera, settings, mesh, **kw)
    dropped = [k for k in ("accel_closest", "backend", "checkpoint_path",
                           "checkpoint_every", "stats")
               if kw.pop(k, None) not in (None, 0)]
    if dropped:
        raise ValueError(
            "scheduler='fused' supports only the base render surface; "
            f"got {dropped}; use scheduler='wave' "
            "(render_sharded_wavefront) for those")
    return render_sharded(scene, camera, settings, mesh, **kw)
