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

The calling process drives the mesh, as the reference's single
controller does: a Mesh is an [n_tile, n_samp] array of torch.device
entries. On cuda the default is every visible card; one card may stand
several times in a mesh (a virtual mesh). Each shard's work runs with its
card as the current device (_on), as the kernels' launches need.

The shards run at once, a worker per group of shards (_groups): on cuda a
worker drives every shard of one card, so the cards of a mesh are driven
concurrently while the entries of a virtual mesh share their card's one
worker, whose queue they would share anyway; on the CPU every entry has
its own worker. The workers (parallel.workers) are threads or, where a
mesh spans two cards or more, one persistent process a card: threads
issuing eager torch at once spend their time handing the interpreter's
lock to each other. A worker issues its shards' work and makes its own
host reads (a shadow cascade's live counts) without waiting for the
others, which is what lets distinct cards overlap. Where the reference's
shard_map keeps the shards in step, the workers meet at a barrier before
each compaction, so that every shard compacts to the width the largest
live count needs. The psum over "samples" runs on the calling thread once
every worker of a chunk has finished; a worker's exception fails the
render (the others are stopped at their next barrier, and the first error
is raised).

With device="cpu", render_tiled builds a mesh of CPU_DEVICES virtual CPU
entries (the counterpart of the reference tests' virtual host devices).
The reference's executable cache (_mexe, clear_mesh_caches) has no
counterpart: eager torch compiles nothing to cache.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel, build_clusters
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core import threefry
from path_tracer_ai_tpu_torch.core.types import SceneData
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.engine import tracer, wavefront
from path_tracer_ai_tpu_torch.engine.oracle import finish_image
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt_io
from path_tracer_ai_tpu_torch.parallel import workers
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


def _layout(mesh_shape: dict, settings: RenderSettings, block_size: int,
            pix_chunk: int):
    """The reference's per-tile pixel blocks: p_loc pixels a tile (padded
    to whole chunks of `chunk` lanes, a multiple of block_size), and the
    pixel coordinates [n_tile, p_loc] (padding replays pixel 0)."""
    w, h = settings.width, settings.height
    n_tile = mesh_shape["tiles"]
    npix = w * h
    p_loc = -(-npix // n_tile)
    chunk = min(pix_chunk, p_loc)
    chunk = -(-chunk // block_size) * block_size
    p_loc = -(-p_loc // chunk) * chunk
    pix = torch.arange(n_tile * p_loc, dtype=torch.int64)
    pix = torch.where(pix < npix, pix, 0)
    return p_loc, chunk, (pix % w).reshape(n_tile, p_loc), \
        (pix // w).reshape(n_tile, p_loc)


def _groups(shards) -> list:
    """The shard indices each worker drives: one worker a card on cuda
    (workers that share a card share its queue, and a worker a shard made
    the virtual (2, 2) mesh 2.4x slower: PERF.md), else one a shard."""
    groups = {}
    for i, dev in enumerate(shards):
        groups.setdefault(dev if dev.type == "cuda" else i, []).append(i)
    return list(groups.values())


def _psum(parts, dev):
    """The reference's psum over "samples": the row's partial sums, in
    ascending sample order, on the row's first device."""
    out = parts[0].to(dev)
    for part in parts[1:]:
        out = out + part.to(dev)
    return out


def _wavefront_config() -> dict:
    """wavefront's module-level settings (the engine tables and switches),
    which a worker process takes over."""
    return {k: v for k, v in vars(wavefront).items()
            if (k.isupper() or k == "_BOUNCE_TIMING")
            and isinstance(v, (dict, bool, int, float, str))}


def _job(kind, scene, camera, settings, mesh, accel, block_size, pix_chunk,
         backend=None, accel_closest=None, compact_min_bucket=None):
    """What a worker needs to drive a render's shards: kind "wave"
    (render_sharded_wavefront) or "fused" (render_sharded)."""
    shards = [(ti, si, dev) for ti, row in enumerate(mesh.devices)
              for si, dev in enumerate(row)]
    return SimpleNamespace(
        kind=kind, scene=scene, camera=camera, settings=settings,
        seed=settings.seed if settings.seed is not None else 0,
        mesh_shape=mesh.shape, shards=shards, n_shards=len(shards),
        accel=accel, accel_closest=accel_closest, block_size=block_size,
        pix_chunk=pix_chunk, backend=backend,
        compact_min_bucket=compact_min_bucket, config=_wavefront_config(),
        profile=workers.PROFILE)


def step_context(job) -> SimpleNamespace:
    """A worker's state for a render: its replicas (built per device at
    first use) and the pixel layout."""
    def make_backend(dev):
        if job.kind == "fused":
            return wavefront.packet_backend(job.accel.to(dev), job.block_size)
        acc_c = (job.accel_closest.to(dev) if job.accel_closest is not None
                 else None)
        return wavefront.packet_backend(job.accel.to(dev), job.block_size,
                                        backend=job.backend,
                                        accel_closest=acc_c, packs={})

    p_loc, chunk, xs, ys = _layout(job.mesh_shape, job.settings,
                                   job.block_size, job.pix_chunk)
    return SimpleNamespace(
        reps=_Replicas(job.scene, job.camera, job.seed, make_backend),
        p_loc=p_loc, chunk=chunk, xs=xs, ys=ys)


def run_step(job, ctx, group, step, meet) -> dict:
    """One step of a render for the shards in `group`: ("wave", j, lo,
    want_stats) or ("fused", lo). meet(depth, {shard: live lanes}) returns
    the largest live count over every shard of the mesh."""
    if step[0] == "wave":
        return _wave_step(job, ctx, group, *step[1:], meet)
    return _fused_step(job, ctx, group, *step[1:])


def _fused_step(job, ctx, group, lo) -> dict:
    """{shard: (radiance sum [chunk, 3], valid count [chunk])} over the
    shard's samples of pixel chunk lo (tracer.trace_paths)."""
    s_all = job.settings
    w, h, spp = s_all.width, s_all.height, s_all.samples_per_pixel
    n_samp = job.mesh_shape["samples"]
    chunk = ctx.chunk
    out = {}
    for i in group:
        ti, si, dev = job.shards[i]
        r = ctx.reps.get(dev)
        with _on(dev):
            xs = ctx.xs[ti, lo:lo + chunk].to(dev)
            ys = ctx.ys[ti, lo:lo + chunk].to(dev)
            a = torch.zeros((chunk, 3), dtype=torch.float32, device=dev)
            c = torch.zeros((chunk,), dtype=torch.int32, device=dev)
            for j in range(-(-spp // n_samp)):
                s = si + j * n_samp  # global sample index
                o, d, keys, _ = wavefront._wave_gen(
                    r.camera, r.base_key, xs, ys, s, w=w, h=h, sc=1,
                    lanes_padded=chunk, aspect=s_all.aspect_ratio())
                radiance, valid, _ = tracer.trace_paths(
                    r.scene, o, d, keys, s_all.max_bounces, *r.backend,
                    rr_start=s_all.rr_start)
                valid = valid & (s < spp)  # the strided tail past spp
                a = a + torch.where(valid[:, None], radiance, 0.0)
                c = c + valid.to(torch.int32)
        out[i] = (a, c)
    return out


def _wave_step(job, ctx, group, j, lo, want_stats, meet) -> dict:
    """{shard: (radiance [chunk, 3] of its valid lanes, valid [chunk] i32,
    live closest rays, live shadow rays)} of pass j, pixel chunk lo, through
    the host-stepped bounce loop with compaction (the ray counts read only
    with want_stats, else None). Before each bounce past 0 the group posts
    its live counts and every shard compacts to the bucket of the largest
    over the mesh (meet)."""
    s_all = job.settings
    w, h, spp = s_all.width, s_all.height, s_all.samples_per_pixel
    n_samp = job.mesh_shape["samples"]
    chunk = ctx.chunk
    lanes = {}
    for i in group:
        ti, si, dev = job.shards[i]
        r = ctx.reps.get(dev)
        s = j * n_samp + si  # global sample index
        with _on(dev):
            o, d, keys, _ = wavefront._wave_gen(
                r.camera, r.base_key, ctx.xs[ti, lo:lo + chunk].to(dev),
                ctx.ys[ti, lo:lo + chunk].to(dev), s, w=w, h=h, sc=1,
                lanes_padded=chunk, aspect=s_all.aspect_ratio())
            # the strided tail past spp renders dead
            alive = torch.full((chunk,), s < spp, dtype=torch.bool,
                               device=dev)
            lanes[i] = wavefront._Lanes(o, d, keys, alive)
    for depth in range(s_all.max_bounces):
        if depth > 0:
            counts = {}
            for i in group:
                with _on(job.shards[i][2]):
                    counts[i] = sync.host_int(lanes[i].alive.sum())
            n_max = meet(depth, counts)
            bucket = wavefront._compact_bucket(n_max, job.compact_min_bucket)
            if n_max > 0 and bucket <= lanes[group[0]].width // 2:
                for i in group:
                    with _on(job.shards[i][2]):
                        lanes[i].compact(counts[i], bucket)
        for i in group:
            dev = job.shards[i][2]
            r = ctx.reps.get(dev)
            with _on(dev):
                lanes[i].step(r.scene, r.backend, depth, s_all.rr_start)
    out = {}
    for i in group:
        _ti, si, dev = job.shards[i]
        with _on(dev):
            rad = lanes[i].final_radiance()
            valid = (torch.isfinite(rad).all(dim=-1)
                     & (j * n_samp + si < spp))
            rays = ((sync.host_int(lanes[i].nc), sync.host_int(lanes[i].ns))
                    if want_stats else (None, None))
            out[i] = (torch.where(valid[:, None], rad, 0.0),
                      valid.to(torch.int32)) + rays
    return out


class _Driver:
    """Runs a render's steps on its workers: one a group of shards
    (_groups), threads or one persistent process a card
    (parallel.workers); {shard: result} a step."""

    def __init__(self, job, mesh):
        self.job = job
        devs = [dev for row in mesh.devices for dev in row]
        self.groups = _groups(devs)
        group_devs = [devs[g[0]] for g in self.groups]
        if any(d.type == "cuda" for d in devs):
            # every library, once, before any worker launches
            cuda_build.build_all(cuda_build.sources())
        if workers.use_processes(group_devs):
            self.procs = workers.process_workers(group_devs)
            self.procs.start(job)
        else:
            self.procs = None
            self.ctx = step_context(job)
            for dev in set(devs):  # replicas before the threads start
                self.ctx.reps.get(dev)
            self.threads = workers.ThreadWorkers(len(self.groups),
                                                 job.n_shards)

    def run(self, step) -> dict:
        if self.procs is not None:
            results = self.procs.run([(g, step) for g in self.groups])
        else:
            results = self.threads.run(
                [lambda g=g: run_step(self.job, self.ctx, g, step,
                                      self.threads.meet)
                 for g in self.groups])
        out = {}
        for res in results:
            out.update(res)
        return out


def render_sharded(scene: SceneData, camera: Camera,
                   settings: RenderSettings, mesh: Mesh,
                   accel: Optional[ClusterAccel] = None,
                   block_size: int = 256, pix_chunk: int = PIX_CHUNK
                   ) -> np.ndarray:
    """Pixels sharded over "tiles", samples over "samples"; each shard
    traces whole paths (tracer.trace_paths: every bounce of a chunk at full
    width, no compaction) on the default backend."""
    w, h = settings.width, settings.height
    if accel is None:
        accel = build_clusters(scene.triangles, device=mesh.devices[0][0])
    job = _job("fused", scene, camera, settings, mesh, accel, block_size,
               pix_chunk)
    driver = _Driver(job, mesh)
    npix = w * h
    p_loc, chunk, _xs, _ys = _layout(mesh.shape, settings, block_size,
                                     pix_chunk)
    acc = [torch.zeros((p_loc, 3), dtype=torch.float32, device=row[0])
           for row in mesh.devices]
    cnt = [torch.zeros((p_loc,), dtype=torch.int32, device=row[0])
           for row in mesh.devices]
    for lo in range(0, p_loc, chunk):
        sums = driver.run(("fused", lo))
        for ti, row in enumerate(mesh.devices):
            parts = [sums[i] for i, sh in enumerate(job.shards)
                     if sh[0] == ti]
            with _on(row[0]):
                acc[ti][lo:lo + chunk] = _psum([p[0] for p in parts], row[0])
                cnt[ti][lo:lo + chunk] = _psum([p[1] for p in parts], row[0])
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
    lives on its device, and the workers (_groups) step their shards
    concurrently. Before each compaction they meet at a barrier with their
    live counts, and every shard compacts to the bucket of the largest
    count, so all shards keep one width (the reference's shard_map runs
    them in step). Checkpoints are per pass (n_samp samples); a checkpoint
    whose sample count the samples axis does not divide cannot resume here
    (ValueError)."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n_tile, n_samp = mesh.shape["tiles"], mesh.shape["samples"]
    dev0 = mesh.devices[0][0]
    if accel is None:
        accel = build_clusters(scene.triangles, device=dev0)
    seed = settings.seed if settings.seed is not None else 0
    npix = w * h
    p_loc, chunk, _xs, _ys = _layout(mesh.shape, settings, block_size,
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

    job = _job("wave", scene, camera, settings, mesh, accel, block_size,
               pix_chunk, backend=backend, accel_closest=accel_closest,
               compact_min_bucket=compact_min_bucket)
    t_start = time.perf_counter()
    driver = _Driver(job, mesh) if j_start < spp_loc else None
    passes_done = 0
    for j in range(j_start, spp_loc):
        for lo in range(0, p_loc, chunk):
            parts = driver.run(("wave", j, lo, stats is not None))
            for ti, row in enumerate(mesh.devices):
                row_parts = [parts[i] for i, sh in enumerate(job.shards)
                             if sh[0] == ti]
                with _on(row[0]):
                    a = _psum([p[0] for p in row_parts], row[0])
                    c = _psum([p[1] for p in row_parts], row[0])
                    acc[ti][lo:lo + chunk] = acc[ti][lo:lo + chunk] + a
                    cnt[ti][lo:lo + chunk] = cnt[ti][lo:lo + chunk] + c
            if stats is not None:
                stats.closest_rays += sum(p[2] for p in parts.values())
                stats.shadow_rays += sum(p[3] for p in parts.values())
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
