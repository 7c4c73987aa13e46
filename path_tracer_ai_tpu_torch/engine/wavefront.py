"""Wavefront engine: the accelerated render path (counterpart of
engine/wavefront.py, `render` with scheduler="wave" on the hybrid backend).

Rays are processed in fixed-size waves:

  generate wave -> [bounce loop, stepped from the host] -> accumulate

- closest waves: accel.ctiles over a second accel of S=256 clusters
  (HYBRID_CLOSEST_CLUSTER_SIZE), built from the original triangles so the
  edge vectors stay bit-identical to the oracle's;
- shadow waves: accel.traverse.any_hit_packets over the S=128 base accel
  (blocks of `block_size` rays, groups of 2 candidates, "dir" sort);
- bounce 0 skips the coherence sort of both wave types (primary rays in
  pixel order are already coherent);
- live-lane compaction: when the live count fits in half the current wave,
  the live lanes are gathered into a power-of-2 bucket and their radiance
  scattered back at the end.

RNG streams are keyed by (pixel, sample, bounce, purpose) only, so the
image does not depend on wave size or compaction, and equals the oracle's
for the same seed (tests/test_torch_render.py holds both).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from path_tracer_ai_tpu_torch.accel import cuda_ctiles, ctiles, traverse
from path_tracer_ai_tpu_torch.accel.clusters import ClusterAccel, build_clusters
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core import sampling, threefry
from path_tracer_ai_tpu_torch.core.types import RAY_TMIN, SceneData
from path_tracer_ai_tpu_torch.device import resolve_device
from path_tracer_ai_tpu_torch.engine import tracer
from path_tracer_ai_tpu_torch.engine.oracle import (
    camera_rays,
    finish_image,
    resolve_seed,
)
from path_tracer_ai_tpu_torch.scene.camera import Camera
from path_tracer_ai_tpu_torch.scene.scene import scene_to
from path_tracer_ai_tpu_torch.utils import sync
from path_tracer_ai_tpu_torch.utils.logging import get_logger, render_banner

log = get_logger(__name__)

# Shadow waves: the packet cascade, groups of 2 candidates per iteration.
HYBRID_OCCLUDE_KW = dict(block_size=64, group_size=2)
# Closest waves: ctiles with the reference's committed defaults.
CTILES_CLOSEST_KW = dict(cap=48, tile_chunk=2048, fallback_compact=1 << 12)
HYBRID_CLOSEST_CLUSTER_SIZE = 256
# Compaction never shrinks a wave below this many lanes.
COMPACT_MIN_BUCKET = 1 << 16


class RenderStats:
    """Per-render counters (rays traced, wall time) for the Mrays/s metric.
    Rays are live closest-hit rays plus live shadow rays."""

    def __init__(self):
        self.closest_rays = 0
        self.shadow_rays = 0
        self.seconds = 0.0

    @property
    def total_rays(self) -> int:
        return self.closest_rays + self.shadow_rays

    @property
    def mrays_per_s(self) -> float:
        return self.total_rays / self.seconds / 1e6 if self.seconds > 0 else 0.0


def hybrid_backend(accel: ClusterAccel, accel_closest: ClusterAccel,
                   pack, pack_closest, sort: bool):
    """(closest_fn, occlude_fn) of the hybrid backend. `pack` and
    `pack_closest` are the tile-sweep triangle packs of the two accels;
    `sort` turns the coherence sort of both wave types on."""

    # The labels name the two wave types in a torch.profiler trace.
    def closest(o, d, t_min, t_max):
        with record_function("closest_wave"):
            return ctiles.closest_hit_ctiles(
                accel_closest, o, d, RAY_TMIN, t_max, sort=sort,
                tri_pack=pack_closest, **CTILES_CLOSEST_KW)

    def occlude(o, d, t_max):
        with record_function("shadow_wave"):
            return traverse.any_hit_packets(
                accel, o, d, RAY_TMIN, t_max, sort=sort, tri_pack=pack,
                **HYBRID_OCCLUDE_KW)

    return closest, occlude


def _compact_bucket(n_live: int) -> int:
    """Smallest power-of-2 bucket >= max(n_live, COMPACT_MIN_BUCKET)."""
    n = max(n_live, COMPACT_MIN_BUCKET)
    return 1 << max(n - 1, 1).bit_length()


def _wave_gen(camera, base_key, xs, ys, s0, *, w, h, sc, lanes_padded, aspect):
    """Camera rays + per-lane stream keys for one wave of pixels x samples
    (pixel-major: lane = pixel*sc + sample). Padding lanes replay pixel 0
    and are dropped at accumulation."""
    pix_chunk = xs.shape[0]
    dev = xs.device
    pix_idx = ys * w + xs
    lane_pix = pix_idx.repeat_interleave(sc)
    lane_x = xs.repeat_interleave(sc)
    lane_y = ys.repeat_interleave(sc)
    lane_s = torch.arange(sc, dtype=torch.int64, device=dev).repeat(pix_chunk) + s0
    pad = lanes_padded - pix_chunk * sc
    if pad:
        p = lambda a: torch.nn.functional.pad(a, (0, pad))
        lane_pix, lane_x, lane_y, lane_s = p(lane_pix), p(lane_x), p(lane_y), p(lane_s)
    keys = sampling.fold_all(base_key, lane_pix, lane_s)
    o, d = camera_rays(camera, keys, lane_x, lane_y, w, h, aspect)
    return o.contiguous(), d, keys, lane_s


def _wave_accum(radiance, lane_s, spp, *, pix_chunk, sc):
    """Per-pixel sums of valid samples (renderer.hpp:69-73), in sample
    order; samples past spp (a tail pass) are dropped."""
    n_lanes = pix_chunk * sc
    valid = torch.isfinite(radiance).all(dim=-1)[:n_lanes].reshape(pix_chunk, sc)
    valid = valid & (lane_s[:n_lanes].reshape(pix_chunk, sc) < spp)
    r = radiance[:n_lanes].reshape(pix_chunk, sc, 3)
    zero = torch.zeros((), device=radiance.device)
    acc = torch.zeros((pix_chunk, 3), dtype=torch.float32, device=radiance.device)
    for s in range(sc):
        acc = acc + torch.where(valid[:, s, None], r[:, s], zero)
    return acc, valid.sum(dim=1).to(torch.int32)


def _render_wave(scene, camera, base_key, xs, ys, s0, spp, backends, *,
                 w, h, sc, lanes_padded, max_bounces, aspect):
    """One wave through the host-stepped bounce loop with compaction.
    Returns (acc [P,3], cnt [P], n_closest, n_shadow) as device tensors."""
    o, d, keys, lane_s = _wave_gen(camera, base_key, xs, ys, s0, w=w, h=h,
                                   sc=sc, lanes_padded=lanes_padded,
                                   aspect=aspect)
    dev = o.device
    n = o.shape[0]
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    nc = torch.zeros((), dtype=torch.int64, device=dev)
    ns = torch.zeros((), dtype=torch.int64, device=dev)

    full_radiance = None  # [n] radiance once compacted
    full_idx = None       # compact lane -> original lane (n = none)
    for depth in range(max_bounces):
        if depth > 0:
            n_live = sync.host_int(alive.sum())
            cur = o.shape[0]
            bucket = _compact_bucket(n_live)
            if n_live > 0 and bucket <= cur // 2:
                live_idx = torch.nonzero(alive).squeeze(1)
                sync.note()
                idx = torch.full((bucket,), cur, dtype=torch.int64, device=dev)
                idx[:n_live] = live_idx
                if full_radiance is None:
                    full_radiance, full_idx = radiance, idx
                else:
                    # Flush finished lanes' finals, then compose the maps.
                    full_radiance = _scatter_back(full_radiance, radiance,
                                                  full_idx)
                    full_idx = torch.where(
                        idx < cur, full_idx[torch.clamp(idx, max=cur - 1)],
                        full_radiance.shape[0])
                gi = torch.clamp(idx, max=cur - 1)
                live = torch.arange(bucket, device=dev) < n_live
                o = o[gi]
                d = torch.where(live[:, None], d[gi], 1.0)
                beta, radiance, keys, alive = beta[gi], radiance[gi], keys[gi], live
        closest, occlude = backends[0] if depth == 0 else backends[1]
        o, d, beta, radiance, alive, nc_i, ns_i = tracer.bounce_step(
            scene, closest, occlude, o, d, beta, radiance, alive, keys, depth)
        nc = nc + nc_i
        ns = ns + ns_i
    if full_radiance is not None:
        radiance = _scatter_back(full_radiance, radiance, full_idx)
    acc, cnt = _wave_accum(radiance, lane_s, spp, pix_chunk=xs.shape[0], sc=sc)
    return acc, cnt, nc, ns


def _scatter_back(radiance_full, radiance_c, idx):
    """radiance_full[idx] = radiance_c, dropping idx == len (padding)."""
    n = radiance_full.shape[0]
    out = torch.cat([radiance_full, radiance_full[:1]])  # row n is a sink
    out[idx] = radiance_c
    return out[:n]


def render(scene: SceneData, camera: Camera, settings: RenderSettings,
           accel: Optional[ClusterAccel] = None, wave_size: int = 1 << 20,
           stats: Optional[RenderStats] = None,
           accel_closest: Optional[ClusterAccel] = None,
           device=None) -> np.ndarray:
    """Full-frame wavefront render -> linear [H, W, 3] float32 (numpy).

    device: None means cuda (raises without a GPU); "cpu" runs the plain
    versions of the kernels."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    camera = camera.to(dev)
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    aspect = settings.aspect_ratio()
    render_banner(log, settings)

    if accel is None:
        t0 = time.perf_counter()
        accel = build_clusters(scene.triangles, device=dev)
        log.info("Built cluster accel: %d clusters x %d slots (%.3fs)",
                 accel.num_clusters, accel.cluster_size,
                 time.perf_counter() - t0)
    accel = accel.to(dev)
    accel_c = accel_closest
    if accel_c is None:
        accel_c = accel
        if HYBRID_CLOSEST_CLUSTER_SIZE != accel.cluster_size:
            t0 = time.perf_counter()
            accel_c = build_clusters(
                scene.triangles, cluster_size=HYBRID_CLOSEST_CLUSTER_SIZE,
                device=dev)
            log.info("Built closest-path accel: %d clusters x %d slots (%.3fs)",
                     accel_c.num_clusters, accel_c.cluster_size,
                     time.perf_counter() - t0)
    accel_c = accel_c.to(dev)
    pack, pack_c = cuda_ctiles.pack_tris(accel), cuda_ctiles.pack_tris(accel_c)
    # Primary rays in pixel order are already coherent: bounce 0 skips the
    # sort of both wave types.
    backends = (hybrid_backend(accel, accel_c, pack, pack_c, sort=False),
                hybrid_backend(accel, accel_c, pack, pack_c, sort=True))

    base_key = threefry.key(resolve_seed(settings), device=dev)
    npix = w * h
    pix_chunk = min(npix, wave_size)
    sc = min(max(1, wave_size // pix_chunk), spp)
    block = HYBRID_OCCLUDE_KW["block_size"]  # shadow waves: whole blocks
    lanes_padded = -(-(pix_chunk * sc) // block) * block
    n_pix_chunks = math.ceil(npix / pix_chunk)
    pix = torch.arange(n_pix_chunks * pix_chunk, dtype=torch.int64, device=dev)
    pix = torch.where(pix < npix, pix, 0)  # padded pixel slots replay pixel 0
    xs_all, ys_all = pix % w, pix // w

    acc = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((npix,), dtype=torch.int32, device=dev)
    if stats is None:
        stats = RenderStats()
    t_start = time.perf_counter()
    for s0 in range(0, spp, sc):
        for ci in range(n_pix_chunks):
            lo = ci * pix_chunk
            hi = min(lo + pix_chunk, npix)
            a, c, nc, ns = _render_wave(
                scene, camera, base_key, xs_all[lo:lo + pix_chunk],
                ys_all[lo:lo + pix_chunk], s0, spp, backends, w=w, h=h, sc=sc,
                lanes_padded=lanes_padded, max_bounces=settings.max_bounces,
                aspect=aspect)
            acc[lo:hi] = acc[lo:hi] + a[:hi - lo]
            cnt[lo:hi] = cnt[lo:hi] + c[:hi - lo]
            stats.closest_rays += sync.host_int(nc)
            stats.shadow_rays += sync.host_int(ns)
    acc_h = acc.cpu().numpy()
    cnt_h = cnt.cpu().numpy()
    stats.seconds += time.perf_counter() - t_start
    log.info("Traced %.2fM rays (%.2fM closest + %.2fM shadow) at %.1f Mrays/s",
             stats.total_rays / 1e6, stats.closest_rays / 1e6,
             stats.shadow_rays / 1e6, stats.mrays_per_s)
    return finish_image(acc_h, cnt_h, w, h)
