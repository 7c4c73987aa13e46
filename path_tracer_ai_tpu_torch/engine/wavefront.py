"""Wavefront engine: the accelerated render path (counterpart of
engine/wavefront.py).

With scheduler="wave" (the default) rays are processed in fixed-size
waves:

  generate wave -> [bounce loop, stepped from the host] -> accumulate

scheduler="pool" keeps one wave-sized pool of lanes and refills each lane
with the next camera ray as its path ends (_render_pool); tile_devices
shards the frame over a mesh of devices (parallel.mesh).

The traversal backend (`packet_backend`) is "hybrid" by default up to
2048 clusters, "worklist" past that (default_backend). The hybrid one:
- closest waves: accel.ctiles over a second accel of S=256 clusters
  (HYBRID_CLOSEST_CLUSTER_SIZE), built from the original triangles so the
  edge vectors stay bit-identical to the oracle's; or, with
  HYBRID_CLOSEST_KW = dict(engine="cascade_fused"), the fused closest
  cascade (accel.cuda_closest) over the base accel;
- shadow waves: accel.traverse.any_hit_packets over the S=128 base accel
  (blocks of `block_size` rays, groups of 2 candidates, "dir" sort); or,
  with HYBRID_OCCLUDE_KW = dict(engine="packets_fused", ...), the fused
  any-hit cascade (accel.cuda_anyhit); exact_cull=K in HYBRID_OCCLUDE_KW
  (or, for cascade_fused, in HYBRID_CLOSEST_KW) culls per ray exactly
  (traverse._exact_block_candidates), with the same image; or, with
  HYBRID_OCCLUDE_KW = dict(engine="ctiles", ...), ctiles.any_hit_ctiles;
- bounce 0 skips the coherence sort of both wave types (primary rays in
  pixel order are already coherent).
backend="ctiles" sends both wave types through accel.ctiles on the base
accel (CTILES_CLOSEST_KW; shadow waves lane-major, CTILES_OCCLUDE_KW);
backend="perray" (or block_size=1) through traverse's per-ray candidate
queries, PERRAY_CHUNK rays at a time.
backend="pallas" (or use_pallas=True) sends both wave types through the
per-block candidate walks of accel.cuda_sweep, one kernel launch per wave.
backend="worklist" runs both through accel.worklist (the item sweep of
accel.cuda_items; shadow waves unsorted, or the exact-cull packet cascade
with WORKLIST_OCCLUDE_ENGINE = "packets_exact") on the base accel, with no
second accel and no bounce-0 overrides; "pairs" through accel.pairs; "packets"
through the packet cascades (traverse.closest_hit_packets,
any_hit_packets) at `block_size`; "kslots" through accel.kslots (per-ray
K slots, the sweep kernel of accel.cuda_kslots; KSLOTS_CLOSEST_KW,
KSLOTS_OCCLUDE_KW).
On cuda every engine launches its kernels; on cpu their plain versions.

Live-lane compaction: when the live count fits in half the current wave,
the live lanes are gathered into a power-of-2 bucket and their radiance
scattered back at the end.

RNG streams are keyed by (pixel, sample, bounce, purpose) only, so the
image does not depend on wave size or compaction, and equals the oracle's
for the same seed (tests/test_torch_render.py holds both).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from path_tracer_ai_tpu_torch.accel import (
    ctiles,
    cuda_anyhit,
    cuda_closest,
    cuda_ctiles,
    cuda_sweep,
    kslots,
    pairs,
    traverse,
    worklist,
)
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
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt_io
from path_tracer_ai_tpu_torch.scene.camera import Camera
from path_tracer_ai_tpu_torch.scene.scene import scene_to
from path_tracer_ai_tpu_torch.utils import sync
from path_tracer_ai_tpu_torch.utils.logging import get_logger, render_banner

log = get_logger(__name__)

# Shadow-wave engine of the hybrid backend: "packets" (the packet cascade,
# groups of 2 candidates per iteration; takes block_size, group_size, sort,
# sort_mode, exact_cull), "packets_fused" (accel.cuda_anyhit;
# takes early_skip, sub_skip, sort, sort_mode, block_size), "worklist" or
# "ctiles" (ctiles.any_hit_ctiles with the other keys as its options;
# lane_major=True, default False, asks direct_lighting for lane-major
# shadow waves).
HYBRID_OCCLUDE_KW = dict(engine="packets", group_size=2)
# Closest-wave engine of the hybrid backend: "ctiles" or "cascade_fused"
# (accel.cuda_closest, on the base accel; takes sub_skip, sort, sort_mode,
# block_size, kernel_chunk).
HYBRID_CLOSEST_KW = dict(engine="ctiles")
# ctiles closest waves: the reference's committed defaults (the overflow
# completes in the sorted domain, before the unsort), less its tile_chunk:
# the card sweeps every live tile in one launch.
CTILES_CLOSEST_KW = dict(cap=48, fallback_compact=1 << 12,
                         fallback_sorted=True)
# The "ctiles" backend's shadow waves: lane-major (each lane's 4 same-origin
# rays consecutive), one block of 4 a lane, unsorted.
CTILES_OCCLUDE_KW = dict(lane_major=True, block=4, sort=False)
# The "perray" backend's waves go through traverse's perray queries this
# many rays at a time (their temporaries grow with the rays); the images do
# not depend on it.
PERRAY_CHUNK = 1 << 16
HYBRID_CLOSEST_CLUSTER_SIZE = 256
# The worklist backend (the reference's default past 2048 clusters): its
# closest waves' options, and its shadow waves' (light-major, already
# coherent: no sort).
WORKLIST_CLOSEST_KW = dict(cap=96, item_budget=8)
WORKLIST_OCCLUDE_KW = dict(sort=False)
# Shadow engine of the worklist backend: "worklist" (any_hit_worklist) or
# "packets_exact" (the packet cascade with the per-ray-exact 2-level cull,
# WORKLIST_OCCLUDE_PACKETS_KW). Occlusion is exact either way: the images
# are the same.
WORKLIST_OCCLUDE_ENGINE = "worklist"
WORKLIST_OCCLUDE_PACKETS_KW = dict(block_size=64, group_size=2,
                                   exact_cull=6)
# The kslots backend's budgets: supers and clusters a ray, closest and
# shadow waves (on the base accel; shadow waves light-major).
KSLOTS_CLOSEST_KW = dict(k_supers=6, k_clusters=12)
KSLOTS_OCCLUDE_KW = dict(k_supers=6, k_clusters=8)
# Compaction never shrinks a wave below this many lanes.
COMPACT_MIN_BUCKET = 1 << 16
# PT_BOUNCE_TIMING=1: each bounce step of the wave scheduler synchronises
# its device before and after and logs its lanes and wall ms. Diagnosis
# only: the synchronisation stalls the host's issue, so it is never on
# for a timed render.
_BOUNCE_TIMING = os.environ.get("PT_BOUNCE_TIMING") == "1"


class RenderStats:
    """Per-render counters (rays traced, wall time) for the Mrays/s metric.
    Rays are live closest-hit rays plus live shadow rays."""

    def __init__(self):
        self.closest_rays = 0
        self.shadow_rays = 0
        self.seconds = 0.0
        self.pool_iterations = []  # scheduler="pool": iterations a pixel chunk

    @property
    def total_rays(self) -> int:
        return self.closest_rays + self.shadow_rays

    @property
    def mrays_per_s(self) -> float:
        return self.total_rays / self.seconds / 1e6 if self.seconds > 0 else 0.0


def default_backend(accel: Optional[ClusterAccel] = None) -> str:
    """ "worklist" past 2048 clusters (its 2-level cull keeps the cull
    linear in rays there), else "hybrid", as in the reference."""
    if accel is not None and accel.num_clusters > 2048:
        return "worklist"
    return "hybrid"


def resolve_backend(accel, block_size: int, use_pallas: bool,
                    backend: Optional[str]) -> str:
    """The backend's name; None resolves through the reference's legacy
    flags (use_pallas=True -> "pallas", block_size == 1 -> "perray"), else
    to default_backend(accel)."""
    if backend is not None:
        return backend
    if use_pallas:
        return "pallas"
    if block_size == 1:
        return "perray"
    return default_backend(accel)


def _labelled(label, fn):
    """fn under a label that names the wave type in a torch.profiler trace
    (keeping its lane_major flag, which direct_lighting reads)."""
    def run(*args):
        with record_function(label):
            return fn(*args)
    run.lane_major = getattr(fn, "lane_major", False)
    return run


def packet_backend(accel: ClusterAccel, block_size: int = 256,
                   use_pallas: bool = False, backend: Optional[str] = None,
                   accel_closest: Optional[ClusterAccel] = None,
                   occlude_sort: Optional[bool] = None,
                   closest_sort: Optional[bool] = None,
                   packs: Optional[dict] = None):
    """(closest_fn, occlude_fn) over the cluster structure.

    backend: "hybrid" (per-wave-type engines, see HYBRID_CLOSEST_KW and
    HYBRID_OCCLUDE_KW), "pallas" (accel.cuda_sweep), "worklist"
    (WORKLIST_CLOSEST_KW, WORKLIST_OCCLUDE_KW), "ctiles" (both wave types
    through accel.ctiles on the base accel: CTILES_CLOSEST_KW,
    CTILES_OCCLUDE_KW), "perray" (traverse's perray queries, PERRAY_CHUNK
    rays at a time), "pairs" or "packets" (block_size rays a block),
    "kslots" (KSLOTS_CLOSEST_KW, KSLOTS_OCCLUDE_KW); None: see
    resolve_backend. occlude_sort /
    closest_sort override the hybrid engines' coherence sort (the bounce-0
    no-sort); the other backends ignore them, as in the reference. packs: a
    dict that keeps the triangle packs and the slab table between calls
    over the same accels (render builds its two backends from one). An
    unknown backend or hybrid engine raises ValueError (the reference sends
    an unknown shadow engine to the worklist)."""
    backend = resolve_backend(accel, block_size, use_pallas, backend)
    packs = {} if packs is None else packs

    def packed(build, acc):
        name = (build.__name__, id(acc))
        if name not in packs:
            packs[name] = build(acc)
        return packs[name]

    if backend == "pallas":
        slab = packed(cuda_sweep.build_slab_table, accel)

        def closest(o, d, t_min, t_max):
            return cuda_sweep.closest_hit_pallas(
                accel, slab, o, d, RAY_TMIN, t_max, block_size=block_size)

        def occlude(o, d, t_max):
            return cuda_sweep.any_hit_pallas(
                accel, slab, o, d, RAY_TMIN, t_max, block_size=block_size)

        return _labelled_pair(closest, occlude)

    if backend in ("worklist", "pairs", "packets", "kslots"):
        return _labelled_pair(*_other_backend(accel, backend, block_size,
                                              packed(cuda_ctiles.pack_tris,
                                                     accel)))

    if backend == "perray":
        return _labelled_pair(*_perray_backend(
            accel, packed(cuda_ctiles.pack_tris, accel)))

    if backend == "ctiles":
        ckw = dict(CTILES_CLOSEST_KW, **_ctiles_packs(packed, accel,
                                                       CTILES_CLOSEST_KW))

        def closest(o, d, t_min, t_max):
            return ctiles.closest_hit_ctiles(accel, o, d, RAY_TMIN, t_max,
                                             **ckw)

        return _labelled_pair(closest, _ctiles_occlude(
            accel, dict(CTILES_OCCLUDE_KW), packed, lane_major=True))

    if backend != "hybrid":
        raise ValueError(f"backend {backend!r} is unknown")

    closest_eng = HYBRID_CLOSEST_KW.get("engine", "ctiles")
    cckw = {k: v for k, v in HYBRID_CLOSEST_KW.items() if k != "engine"}
    if closest_sort is not None:
        cckw["sort"] = closest_sort
    if closest_eng == "cascade_fused":
        pack_fused = packed(cuda_anyhit.pack_tris_dummy, accel)

        def closest(o, d, t_min, t_max):
            return cuda_closest.closest_hit_fused(
                accel, o, d, RAY_TMIN, t_max, tri_pack=pack_fused, **cckw)
    elif closest_eng == "ctiles":
        accel_cl = accel_closest if accel_closest is not None else accel
        ckw = dict(CTILES_CLOSEST_KW, **_ctiles_packs(packed, accel_cl,
                                                       CTILES_CLOSEST_KW))
        if closest_sort is not None:
            ckw["sort"] = closest_sort

        def closest(o, d, t_min, t_max):
            return ctiles.closest_hit_ctiles(
                accel_cl, o, d, RAY_TMIN, t_max, **ckw)
    else:
        raise ValueError(f"hybrid closest engine {closest_eng!r} is unknown")

    occlude_eng = HYBRID_OCCLUDE_KW.get("engine")
    okw = {k: v for k, v in HYBRID_OCCLUDE_KW.items() if k != "engine"}
    sort = okw.get("sort", True) if occlude_sort is None else occlude_sort
    if occlude_eng == "packets":
        pack = packed(cuda_ctiles.pack_tris, accel)
        pkw = dict(block_size=okw.get("block_size", block_size),
                   group_size=okw.get("group_size", 8),
                   sort_mode=okw.get("sort_mode", "dir"),
                   exact_cull=okw.get("exact_cull", 0), sort=sort)

        def occlude(o, d, t_max):
            return traverse.any_hit_packets(
                accel, o, d, RAY_TMIN, t_max, tri_pack=pack, **pkw)
    elif occlude_eng == "worklist":
        pack = packed(cuda_ctiles.pack_tris, accel)

        def occlude(o, d, t_max):
            return worklist.any_hit_worklist(
                accel, o, d, RAY_TMIN, t_max, tri_pack=pack, **okw)
    elif occlude_eng == "packets_fused":
        pack_dummy = packed(cuda_anyhit.pack_tris_dummy, accel)
        fkw = dict(block_size=okw.get("block_size", 128),
                   sort_mode=okw.get("sort_mode", "dir"),
                   early_skip=okw.get("early_skip", False),
                   sub_skip=okw.get("sub_skip", False),
                   exact_cull=okw.get("exact_cull", 0), sort=sort)

        def occlude(o, d, t_max):
            return cuda_anyhit.any_hit_fused(
                accel, o, d, RAY_TMIN, t_max, tri_pack=pack_dummy, **fkw)
    elif occlude_eng == "ctiles":
        occlude = _ctiles_occlude(accel, okw, packed, lane_major=False)
    else:
        raise ValueError(f"hybrid shadow engine {occlude_eng!r} is unknown")

    return _labelled_pair(closest, occlude)


def _labelled_pair(closest, occlude):
    return (_labelled("closest_wave", closest),
            _labelled("shadow_wave", occlude))


def _ctiles_packs(packed, accel, kw) -> dict:
    """The packs of a ctiles query with options kw over `accel`, each built
    once: tri_pack and the sweep's pack (the same one unless kw turns on
    sub_skip or pallas_pack_t)."""
    build = ctiles.sweep_pack_builder(kw.get("sub_skip", False),
                                      kw.get("pallas_pack_t", False))
    return dict(tri_pack=packed(cuda_ctiles.pack_tris, accel),
                sweep_pack=packed(build, accel))


def _ctiles_occlude(accel, okw, packed, lane_major: bool):
    """Shadow waves through ctiles.any_hit_ctiles with the options okw;
    okw's lane_major (default `lane_major`) is popped and set on the
    function, for direct_lighting."""
    lane_major = okw.pop("lane_major", lane_major)
    kw = dict(okw, **_ctiles_packs(packed, accel, okw))

    def occlude(o, d, t_max):
        return ctiles.any_hit_ctiles(accel, o, d, RAY_TMIN, t_max, **kw)

    occlude.lane_major = lane_major
    return occlude


def _perray_backend(accel, pack):
    """(closest, occlude) of the "perray" backend (wavefront.py:392-440):
    traverse.closest_hit_perray / any_hit_perray over PERRAY_CHUNK rays at a
    time."""
    def chunked(fn, o, d, t_max):
        n = o.shape[0]
        t_max = torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=o.device), (n,))
        c = PERRAY_CHUNK
        if n <= c:
            return fn(o, d, t_max)
        parts = [fn(o[lo:lo + c], d[lo:lo + c], t_max[lo:lo + c])
                 for lo in range(0, n, c)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def closest(o, d, t_min, t_max):
        def core(oo, dd, tt):
            h = traverse.closest_hit_perray(accel, oo, dd, RAY_TMIN, tt,
                                            tri_pack=pack)
            return h.t, h.tri
        t, tri = chunked(core, o, d, t_max)
        return traverse.PacketHit(hit=torch.isfinite(t), t=t, tri=tri)

    def occlude(o, d, t_max):
        def core(oo, dd, tt):
            return (traverse.any_hit_perray(accel, oo, dd, RAY_TMIN, tt,
                                            tri_pack=pack),)
        return chunked(core, o, d, t_max)[0]

    return closest, occlude


def _other_backend(accel, backend, block_size, pack):
    """(closest, occlude) of the "worklist", "pairs", "packets" and
    "kslots" backends (the reference's packet_backend branches), all on the
    base accel."""
    if backend == "kslots":
        def closest(o, d, t_min, t_max):
            return kslots.closest_hit_kslots(accel, o, d, RAY_TMIN, t_max,
                                             tri_pack=pack,
                                             **KSLOTS_CLOSEST_KW)

        def occlude(o, d, t_max):
            return kslots.any_hit_kslots(accel, o, d, RAY_TMIN, t_max,
                                         tri_pack=pack, **KSLOTS_OCCLUDE_KW)
    elif backend == "worklist":
        def closest(o, d, t_min, t_max):
            return worklist.closest_hit_worklist(
                accel, o, d, RAY_TMIN, t_max, tri_pack=pack,
                **WORKLIST_CLOSEST_KW)

        if WORKLIST_OCCLUDE_ENGINE == "packets_exact":
            def occlude(o, d, t_max):
                return traverse.any_hit_packets(
                    accel, o, d, RAY_TMIN, t_max, tri_pack=pack,
                    **WORKLIST_OCCLUDE_PACKETS_KW)
        elif WORKLIST_OCCLUDE_ENGINE == "worklist":
            def occlude(o, d, t_max):
                return worklist.any_hit_worklist(
                    accel, o, d, RAY_TMIN, t_max, tri_pack=pack,
                    **WORKLIST_OCCLUDE_KW)
        else:
            raise ValueError("unknown worklist shadow engine "
                             f"{WORKLIST_OCCLUDE_ENGINE!r}")
    elif backend == "pairs":
        def closest(o, d, t_min, t_max):
            return pairs.closest_hit_pairs(accel, o, d, RAY_TMIN, t_max,
                                           tri_pack=pack)

        def occlude(o, d, t_max):
            return pairs.any_hit_pairs(accel, o, d, RAY_TMIN, t_max,
                                       tri_pack=pack)
    else:
        def closest(o, d, t_min, t_max):
            return traverse.closest_hit_packets(accel, o, d, t_min, t_max,
                                                block_size=block_size,
                                                tri_pack=pack)

        def occlude(o, d, t_max):
            return traverse.any_hit_packets(accel, o, d, RAY_TMIN, t_max,
                                            block_size=block_size,
                                            tri_pack=pack)
    return closest, occlude


def _compact_bucket(n_live: int, floor: Optional[int] = None) -> int:
    """Smallest power-of-2 bucket >= max(n_live, floor); floor None means
    COMPACT_MIN_BUCKET."""
    n = max(n_live, COMPACT_MIN_BUCKET if floor is None else floor)
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


class _Lanes:
    """One wave's lanes through the host-stepped bounce loop: rays,
    throughput, radiance, keys and liveness, the live-closest and shadow
    ray counts (0-dim device tensors), and live-lane compaction. The wave
    and pool schedulers hold one; the mesh scheduler one per shard."""

    def __init__(self, o, d, keys, alive):
        dev = o.device
        n = o.shape[0]
        self.o, self.d, self.keys, self.alive = o, d, keys, alive
        self.beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
        self.radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        self.nc = torch.zeros((), dtype=torch.int64, device=dev)
        self.ns = torch.zeros((), dtype=torch.int64, device=dev)
        self.full_radiance = None  # [n] radiance once compacted
        self.full_idx = None       # compact lane -> original lane (n = none)

    @property
    def width(self) -> int:
        return self.o.shape[0]

    def compact(self, n_live: int, bucket: int) -> None:
        """Gathers the live lanes (n_live of them) into the first n_live of
        `bucket` lanes; the rest are dead (d = 1)."""
        dev = self.o.device
        cur = self.width
        live_idx = torch.nonzero(self.alive).squeeze(1)
        sync.note()
        idx = torch.full((bucket,), cur, dtype=torch.int64, device=dev)
        idx[:n_live] = live_idx
        if self.full_radiance is None:
            self.full_radiance, self.full_idx = self.radiance, idx
        else:
            # Flush finished lanes' finals, then compose the maps.
            self.full_radiance = _scatter_back(self.full_radiance,
                                               self.radiance, self.full_idx)
            self.full_idx = torch.where(
                idx < cur, self.full_idx[torch.clamp(idx, max=cur - 1)],
                self.full_radiance.shape[0])
        gi = torch.clamp(idx, max=cur - 1)
        live = torch.arange(bucket, device=dev) < n_live
        self.o = self.o[gi]
        self.d = torch.where(live[:, None], self.d[gi], 1.0)
        self.beta, self.radiance = self.beta[gi], self.radiance[gi]
        self.keys, self.alive = self.keys[gi], live

    def step(self, scene, backend, depth, rr_start: int) -> None:
        """One shading vertex (tracer.bounce_step) of every lane; depth is
        an int or a per-lane int64 tensor."""
        closest, occlude = backend
        (self.o, self.d, self.beta, self.radiance, self.alive, nc,
         ns) = tracer.bounce_step(
            scene, closest, occlude, self.o, self.d, self.beta, self.radiance,
            self.alive, self.keys, depth, rr_start=rr_start)
        self.nc = self.nc + nc
        self.ns = self.ns + ns

    def final_radiance(self):
        """Radiance of every lane of the original wave, in its order."""
        if self.full_radiance is None:
            return self.radiance
        return _scatter_back(self.full_radiance, self.radiance, self.full_idx)


def _synchronize(dev) -> None:
    """Waits for `dev`'s queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _render_wave(scene, camera, base_key, xs, ys, s0, spp, backends, *,
                 w, h, sc, lanes_padded, max_bounces, aspect, rr_start=0):
    """One wave through the host-stepped bounce loop with compaction.
    Returns (acc [P,3], cnt [P], n_closest, n_shadow) as device tensors."""
    o, d, keys, lane_s = _wave_gen(camera, base_key, xs, ys, s0, w=w, h=h,
                                   sc=sc, lanes_padded=lanes_padded,
                                   aspect=aspect)
    lanes = _Lanes(o, d, keys, torch.ones((o.shape[0],), dtype=torch.bool,
                                          device=o.device))
    for depth in range(max_bounces):
        if depth > 0:
            n_live = sync.host_int(lanes.alive.sum())
            bucket = _compact_bucket(n_live)
            if n_live > 0 and bucket <= lanes.width // 2:
                lanes.compact(n_live, bucket)
        if _BOUNCE_TIMING:
            _synchronize(lanes.o.device)
            t_b = time.perf_counter()
        lanes.step(scene, backends[0] if depth == 0 else backends[1], depth,
                   rr_start)
        if _BOUNCE_TIMING:
            _synchronize(lanes.o.device)
            log.info("bounce %d: %d lanes, %.1f ms", depth, lanes.width,
                     (time.perf_counter() - t_b) * 1e3)
    acc, cnt = _wave_accum(lanes.final_radiance(), lane_s, spp,
                           pix_chunk=xs.shape[0], sc=sc)
    return acc, cnt, lanes.nc, lanes.ns


def _render_pool(scene, camera, base_key, xs, ys, s_start, spp, backend, *,
                 w, h, pool_size, max_bounces, aspect, rr_start=0):
    """Persistent-pool scheduler over one pixel chunk (the reference's
    _render_pool_impl): compaction by regeneration.

    A fixed pool of `pool_size` lanes; when a path dies (miss, roulette or
    depth cut) its radiance is scatter-added into the chunk's sums and its
    lane is re-armed with the next emission, in sample-major order (all
    pixels at sample s before s + 1), starting at sample s_start. Lanes
    carry their own depth, so each step is one bounce_step over the whole
    pool with a per-lane depth tensor. The radiance of a sample does not
    depend on the scheduling (keys are folded from (pixel, sample)).
    The reference runs this as a device while_loop on (e < total) |
    any(alive); here the host steps it and reads the live count once an
    iteration: the emission counter e follows from it on the host. Lanes
    never armed hold a constant key (the reference's split keys); they
    are never alive, so it reaches no result.
    Returns (acc [P,3], cnt [P], n_closest, n_shadow, iterations)."""
    dev = xs.device
    p = xs.shape[0]
    n_l = pool_size
    total = p * (spp - s_start)
    pix = ys * w + xs
    d0 = torch.zeros((n_l, 3), dtype=torch.float32, device=dev)
    d0[:, 0] = 1.0
    lanes = _Lanes(torch.zeros((n_l, 3), dtype=torch.float32, device=dev), d0,
                   torch.zeros((n_l, 2), dtype=torch.int64, device=dev),
                   torch.zeros((n_l,), dtype=torch.bool, device=dev))
    p_lane = torch.zeros((n_l,), dtype=torch.int64, device=dev)
    depth = torch.zeros((n_l,), dtype=torch.int64, device=dev)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((p,), dtype=torch.int32, device=dev)
    lane_ids = torch.arange(n_l, dtype=torch.int64, device=dev)
    zero = torch.zeros((), device=dev)
    e = n_alive = iterations = 0
    while e < total or n_alive > 0:
        # refill the first n_take dead lanes (in lane order) with emissions
        # e, e + 1, ...: the reference's rank = cumsum(dead) - 1
        n_take = min(n_l - n_alive, total - e)
        if n_take:
            dead = ~lanes.alive
            rank = torch.cumsum(dead, dim=0) - 1
            take = dead & (rank < n_take)
            slot = torch.where(take, rank, n_take)  # slot n_take: a sink
            idx = torch.empty((n_take + 1,), dtype=torch.int64, device=dev)
            idx = idx.scatter_(0, slot, lane_ids)[:n_take]
            eid = e + torch.arange(n_take, dtype=torch.int64, device=dev)
            pl = eid % p
            k = sampling.fold_all(base_key, pix[pl], s_start + eid // p)
            o_n, d_n = camera_rays(camera, k, xs[pl], ys[pl], w, h, aspect)
            lanes.o[idx], lanes.d[idx], lanes.keys[idx] = o_n, d_n, k
            p_lane[idx] = pl
            lanes.beta[idx] = 1.0
            lanes.radiance[idx] = 0.0
            depth[idx] = 0
            lanes.alive[idx] = True
            e += n_take
        alive_pre = lanes.alive
        lanes.step(scene, backend, depth, rr_start)
        depth = depth + alive_pre
        # retire finished paths into the chunk's sums
        exhausted = lanes.alive & (depth >= max_bounces)
        finish = (alive_pre & ~lanes.alive) | exhausted
        lanes.alive = lanes.alive & ~exhausted
        rad = lanes.radiance
        valid = finish & torch.isfinite(rad).all(dim=-1)
        acc.index_add_(0, p_lane, torch.where(valid[:, None], rad, zero))
        cnt.index_add_(0, p_lane, valid.to(torch.int32))
        n_alive = sync.host_int(lanes.alive.sum())
        iterations += 1
    return acc, cnt, lanes.nc, lanes.ns, iterations


def _scatter_back(radiance_full, radiance_c, idx):
    """radiance_full[idx] = radiance_c, dropping idx == len (padding)."""
    n = radiance_full.shape[0]
    out = torch.cat([radiance_full, radiance_full[:1]])  # row n is a sink
    out[idx] = radiance_c
    return out[:n]


def render(scene: SceneData, camera: Camera, settings: RenderSettings,
           accel: Optional[ClusterAccel] = None, wave_size: int = 1 << 20,
           block_size: int = 64, stats: Optional[RenderStats] = None,
           use_pallas: bool = False, backend: Optional[str] = None,
           accel_closest: Optional[ClusterAccel] = None,
           checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
           show_progress: bool = False, scheduler: str = "wave",
           tile_devices: Optional[int] = None, device=None) -> np.ndarray:
    """Full-frame wavefront render -> linear [H, W, 3] float32 (numpy).

    block_size: rays per traversal block (the packet cascade's and the
    pallas backend's; waves are padded to it). backend / use_pallas: see
    packet_backend. checkpoint_path: resume from it when its fingerprint
    matches these settings, and save to it every `checkpoint_every` sample
    passes (0: never between) and at the end (io.checkpoint).
    scheduler: "wave" (bounded-depth waves with compaction; per-pass
    checkpoints) or "pool" (a persistent pool of wave-sized lanes refilled
    as paths die; saves only at the end, resumes at the checkpoint's
    sample). tile_devices=N shards the frame over N devices
    (parallel.mesh.render_tiled; "wave" only). device: None means cuda
    (raises without a GPU); "cpu" runs the plain versions of the kernels
    (and, with tile_devices, a mesh of virtual CPU entries)."""
    if tile_devices:
        from path_tracer_ai_tpu_torch.parallel.mesh import render_tiled

        if scheduler != "wave":
            # The pool's regeneration has no sharded form; do not silently
            # substitute another scheduler.
            raise ValueError("tile_devices supports only scheduler='wave' "
                             f"(requested {scheduler!r})")
        if settings.seed is None:
            # the sharded path reads seed None as 0: draw it here instead
            settings = settings.replace(seed=resolve_seed(settings))
        return render_tiled(
            scene, camera, settings, n_devices=tile_devices, device=device,
            accel=accel, block_size=block_size, backend=backend,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, stats=stats,
            accel_closest=accel_closest)

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
    pool = scheduler == "pool"
    # Dual-accel hybrid: ctiles closest waves run at another cluster size,
    # built from the ORIGINAL triangles. The fused closest cascade, the
    # pallas backend and the pool (as in the reference) run on the base
    # accel.
    accel_c = accel_closest
    backend = resolve_backend(accel, block_size, use_pallas, backend)
    if (accel_c is None and backend == "hybrid" and not pool
            and HYBRID_CLOSEST_KW.get("engine", "ctiles") == "ctiles"
            and HYBRID_CLOSEST_CLUSTER_SIZE != accel.cluster_size):
        t0 = time.perf_counter()
        accel_c = build_clusters(
            scene.triangles, cluster_size=HYBRID_CLOSEST_CLUSTER_SIZE,
            device=dev)
        log.info("Built closest-path accel: %d clusters x %d slots (%.3fs)",
                 accel_c.num_clusters, accel_c.cluster_size,
                 time.perf_counter() - t0)
    if accel_c is not None and not pool:
        accel_c = accel_c.to(dev)
    if pool:
        # one backend for every lane, whatever its depth: no second accel
        # and no bounce-0 no-sort
        pool_backend = packet_backend(accel, block_size, backend=backend)
    else:
        # Primary rays in pixel order are already coherent: bounce 0 skips
        # the sort of both wave types (hybrid engines only).
        bkw = dict(backend=backend, accel_closest=accel_c, packs={})
        backends = (packet_backend(accel, block_size, occlude_sort=False,
                                   closest_sort=False, **bkw),
                    packet_backend(accel, block_size, **bkw))

    seed = resolve_seed(settings)
    base_key = threefry.key(seed, device=dev)
    npix = w * h
    pix_chunk = min(npix, wave_size)
    sc = min(max(1, wave_size // pix_chunk), spp)
    lanes_padded = -(-(pix_chunk * sc) // block_size) * block_size
    n_pix_chunks = math.ceil(npix / pix_chunk)
    pix = torch.arange(n_pix_chunks * pix_chunk, dtype=torch.int64, device=dev)
    pix = torch.where(pix < npix, pix, 0)  # padded pixel slots replay pixel 0
    xs_all, ys_all = pix % w, pix // w

    # The sums stay on the device; they come to the host only to be saved.
    acc = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((npix,), dtype=torch.int32, device=dev)
    s_start = 0
    fingerprint = ckpt_io.fingerprint(settings, scene.triangles.count, seed)
    if checkpoint_path:
        loaded = ckpt_io.load(checkpoint_path, fingerprint)
        if loaded is not None:
            acc_h, cnt_h, s_start = loaded
            acc = torch.as_tensor(acc_h, device=dev)
            cnt = torch.as_tensor(cnt_h, device=dev)
            log.info("Resuming from checkpoint at sample %d/%d", s_start, spp)
    if stats is None:
        stats = RenderStats()
    t_start = time.perf_counter()
    if pool and s_start < spp:
        for ci in range(n_pix_chunks):
            lo = ci * pix_chunk
            hi = min(lo + pix_chunk, npix)
            # padded pixel slots (pixel 0) are wasted work, cropped here
            a, c, nc, ns, iterations = _render_pool(
                scene, camera, base_key, xs_all[lo:lo + pix_chunk],
                ys_all[lo:lo + pix_chunk], s_start, spp, pool_backend, w=w,
                h=h, pool_size=lanes_padded,
                max_bounces=settings.max_bounces, aspect=aspect,
                rr_start=settings.rr_start)
            acc[lo:hi] = acc[lo:hi] + a[:hi - lo]
            cnt[lo:hi] = cnt[lo:hi] + c[:hi - lo]
            stats.closest_rays += sync.host_int(nc)
            stats.shadow_rays += sync.host_int(ns)
            stats.pool_iterations.append(iterations)
            if show_progress:
                log.info("Rendering progress: %d%% (pool)",
                         ((ci + 1) * 100) // n_pix_chunks)
        if checkpoint_path:
            ckpt_io.save(checkpoint_path, acc.cpu().numpy(),
                         cnt.cpu().numpy(), spp, fingerprint)
    elif not pool:
        passes_done = 0
        for s0 in range(s_start, spp, sc):
            for ci in range(n_pix_chunks):
                lo = ci * pix_chunk
                hi = min(lo + pix_chunk, npix)
                a, c, nc, ns = _render_wave(
                    scene, camera, base_key, xs_all[lo:lo + pix_chunk],
                    ys_all[lo:lo + pix_chunk], s0, spp, backends, w=w, h=h,
                    sc=sc, lanes_padded=lanes_padded,
                    max_bounces=settings.max_bounces, aspect=aspect,
                    rr_start=settings.rr_start)
                acc[lo:hi] = acc[lo:hi] + a[:hi - lo]
                cnt[lo:hi] = cnt[lo:hi] + c[:hi - lo]
                stats.closest_rays += sync.host_int(nc)
                stats.shadow_rays += sync.host_int(ns)
            passes_done += 1
            done = min(s0 + sc, spp)
            if show_progress:
                log.info("Rendering progress: %d%% (%d/%d samples)",
                         (done * 100) // spp, done, spp)
            if checkpoint_path and (
                    (checkpoint_every
                     and passes_done % checkpoint_every == 0)
                    or done >= spp):
                ckpt_io.save(checkpoint_path, acc.cpu().numpy(),
                             cnt.cpu().numpy(), s0 + sc, fingerprint)
    acc_h = acc.cpu().numpy()
    cnt_h = cnt.cpu().numpy()
    stats.seconds += time.perf_counter() - t_start
    log.info("Traced %.2fM rays (%.2fM closest + %.2fM shadow) at %.1f Mrays/s",
             stats.total_rays / 1e6, stats.closest_rays / 1e6,
             stats.shadow_rays / 1e6, stats.mrays_per_s)
    return finish_image(acc_h, cnt_h, w, h)
