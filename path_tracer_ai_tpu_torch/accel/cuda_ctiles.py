"""The cluster-tile sweep: a hand-written CUDA kernel and its plain version.

Replaces path_tracer_ai_tpu/accel/pallas_ctiles.py `tile_sweep` (the
Pallas kernel `_sweep_kernel`/`_mt_rows`). `tile_sweep(tri_pack,
rays_pack, tile_cid)` tests each tile of T rays against the S triangles of
its cluster, or of each of its G clusters, and returns, per lane, the best
t and the minimum triangle id at that t (INT32_MAX on a miss). The same
call serves the closest-hit ctiles sweep (T = 128, S = 256, one cluster a
tile), the pair tiles of accel.pairs (T = 128, S = 128 or 256, one cluster
a tile: the pairs backend and the overflow fallbacks) and the shadow
cascade (T = 64, S = 128, an iteration's G candidates a tile; occluded =
tri != INT32_MAX). G clusters in one call equal G calls folded with
`combine_min_tri`.

`tile_sweep(..., tie="slot")` is its first-slot instance: per lane the
minimum t and the triangle id of the FIRST slot that reaches it, slots
counted cluster i of the tile's G, then triangle j of the cluster
(jnp.argmin's rule), and (inf, INT32_MAX) on a miss. It carries the sweep
of the packet cascade, path_tracer_ai_tpu/accel/traverse.py
`closest_hit_packets` (traverse.py:823-845: XLA-fused there, no Pallas
kernel), which runs in every closest overflow fallback that goes through
the whole wave and in the "packets" backend. Its kernel has tuned
instances for (T, S) in (64, 128) and (256, 128); every other shape goes to
the generic instance. It takes neither option.

Two options, each giving the same bits as the option switched off
(pallas_ctiles.py:168-231): `sub_skip` reads the 16-row pack (pack_tris16)
and sweeps a 32-triangle sub-slab only where some live lane's segment
[t_min, min(t_max, running best)] touches the sub-slab's box; `pack_t`
reads the pre-transposed [C, S, 16] pack (pack_tris16_t). The two cannot
be combined (ValueError, as the reference asserts).

On a CUDA tensor the wrapper launches csrc/ctiles_sweep.cu (built with
nvcc at first use, see cuda_build) or raises; on a CPU tensor it runs
`tile_sweep_plain`, the same arithmetic as eager torch ops. The kernel has
tuned instances for S in {128, 256} and T in {64, 128, 256}, and for S = 2
at T in {64, 128} (a scene cut into clusters of two triangles, for tests of
the worklist backend past 2048 clusters), its options for (T, S) in (128,
128), (128, 256) and (64, 128), the shapes of the ctiles paths; every
other (S, T) with S, T >= 1, options included, goes to its generic
instance (S and T at run time, the same bits). The kernel's design and its
bound are described in the CUDA source.

`slot_sweep` carries the same body over static slot tables, in one
launch that reads the live tile count from device memory: the sweep and
resolve of path_tracer_ai_tpu/accel/ctiles.py `_sweep_resolve` (its
`fori_loop`s over a dynamic chunk count, ctiles.py:629-666; folded per ray
row, closest or any hit) and of accel/pairs.py `_sweep_tiles` (pairs.py:259;
per slot lane). Its tuned instances are the routes' shapes, (T, S) in
(128, 256) and (128, 128) without an option; every other shape and both
options go to its generic instance (the same bits). `block_cull`
(csrc/ctiles_cull.cu) is the flat cull of
ctiles.py `_ray_masks` + `_extract_order_flat` (:81-191), bounded by a
live-block count in device memory. Both carry XLA-fused code, no Pallas
kernel; each has its plain version here (slot_sweep_plain: the chunked
tile_sweep and scatter resolve of before; block_cull_plain: the eager
cull), which CPU tensors take and which may read the count on the host.

Layouts:
  tri_pack [C, 10, S] f32 (pack_tris): v0.xyz, e1.xyz, e2.xyz, tri id
           bit-cast to f32. pack_tris16 [C, 16, S] adds the TPU pack's rows
           10-15, the sub-slab boxes that the `sub_skip` gates read (here
           and in accel.cuda_anyhit, accel.cuda_closest); pack_tris16_t is
           its [C, S, 16] transpose.
  rays     [nt, 8, T] f32 (pack_rays_tiles): ox oy oz dx dy dz t_max t_min.
  tile_cid [nt] or [nt, G] i32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.core.types import MT_EPSILON
from path_tracer_ai_tpu_torch.utils import sync

I32_MAX = 2**31 - 1
INF = float("inf")
PACK_ROWS = 10
RAY_ROWS = 8
SOURCE = "ctiles_sweep"
CULL_SOURCE = "ctiles_cull"

# Kernel launches since the last reset (the plain version never counts),
# those of the generic instance and those of the first-slot instance
# (tie="slot", tuned or generic) among them, and the same split by shape:
# (T, S, G) -> [launches, tiles], with the option ("sub_skip", "pack_t" or
# "slot") where one is on and "generic" where the generic instance ran as
# further elements. Updated under sync.lock (the mesh's workers launch
# from several threads).
launches = 0
generic_launches = 0
slot_launches = 0
launch_shapes: dict = {}
# block_cull's launches at levels 1 and 2 and slot_sweep's (their plain
# versions count nothing), slot_sweep's generic ones, and slot_sweep's by
# shape: (T, S, out[, option][, "generic"]) -> [launches, slot cap in
# tiles].
cull_launches = 0
cull2_launches = 0
sweep_launches = 0
sweep_generic_launches = 0
sweep_shapes: dict = {}

TIES = ("tri", "slot")


def reset_launches() -> None:
    global launches, generic_launches, slot_launches, cull_launches
    global cull2_launches, sweep_launches, sweep_generic_launches
    with sync.lock:
        launches = generic_launches = slot_launches = 0
        cull_launches = cull2_launches = 0
        sweep_launches = sweep_generic_launches = 0
        launch_shapes.clear()
        sweep_shapes.clear()


def combine_min_tri(t_a, tri_a, t_b, tri_b):
    """Lexicographic (t, tri) minimum of two candidates per lane."""
    t_new = torch.minimum(t_a, t_b)
    tri_new = torch.minimum(torch.where(t_a <= t_new, tri_a, I32_MAX),
                            torch.where(t_b <= t_new, tri_b, I32_MAX))
    return t_new, tri_new.to(torch.int32)


def pack_tris(accel) -> torch.Tensor:
    """[C, 10, S] f32 triangle pack of a ClusterAccel."""
    rows = [accel.v0[:, :, k] for k in range(3)]
    rows += [accel.e1[:, :, k] for k in range(3)]
    rows += [accel.e2[:, :, k] for k in range(3)]
    rows.append(accel.tri_id.view(torch.float32))
    return torch.stack(rows, dim=1).contiguous()


SUB = 32  # sub-slab width: triangles per box of pack rows 10-15


def n_subs(s: int) -> int:
    """Sub-slabs per cluster for an S-wide accel."""
    return -(-s // SUB)


def pack_tris16(accel) -> torch.Tensor:
    """[C, 16, S] f32 pack (pallas_ctiles.pack_tris): rows 0-9 as pack_tris;
    rows 10-12 / 13-15 hold lo.xyz / hi.xyz of sub-slab k's AABB at lane k,
    for k < n_subs(S). Padding slots, all-padding sub-slabs and the lanes
    past n_subs hold inverted boxes (lo = +inf, hi = -inf), which fail
    every slab test."""
    c, s = accel.v0.shape[:2]
    ns = n_subs(s)
    pad_s = ns * SUB - s
    v0, v1, v2 = accel.v0, accel.v0 + accel.e1, accel.v0 + accel.e2
    valid = (accel.tri_id >= 0)[..., None]
    inf = float("inf")
    lo = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), inf)
    hi = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2), -inf)
    if pad_s:
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad_s), value=inf)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad_s), value=-inf)
    sub_lo = lo.reshape(c, ns, SUB, 3).amin(dim=2)            # [C, ns, 3]
    sub_hi = hi.reshape(c, ns, SUB, 3).amax(dim=2)
    box_rows = torch.empty((c, 6, s), dtype=torch.float32, device=v0.device)
    box_rows[:, :3] = inf
    box_rows[:, 3:] = -inf
    box_rows[:, :3, :ns] = sub_lo.transpose(1, 2)
    box_rows[:, 3:, :ns] = sub_hi.transpose(1, 2)
    return torch.cat([pack_tris(accel), box_rows], dim=1).contiguous()


def pack_tris16_t(accel) -> torch.Tensor:
    """[C, S, 16] f32: pack_tris16 transposed (the reference's pack_t
    layout: each triangle's words 0-9 contiguous)."""
    return pack_tris16(accel).transpose(1, 2).contiguous()


def sub_pred(box, rays, inv, t_lo, t_hi) -> torch.Tensor:
    """[n] bool: does ANY lane's [t_lo, t_hi] segment touch its block's
    sub-slab box (pallas_ctiles._sub_pred)? box [n, 6] lo.xyz hi.xyz, rays
    [n, 8, T], inv [n, 3, T] = 1/d, t_lo / t_hi [n, T]. Inclusive slab in
    comparison-select form: a NaN keeps the running bound (over-includes).
    Dead lanes (t_hi < 0) fail."""
    lo, hi = t_lo, t_hi
    for axis in range(3):
        o_row, inv_row = rays[:, axis], inv[:, axis]
        t0 = (box[:, axis, None] - o_row) * inv_row
        t1 = (box[:, 3 + axis, None] - o_row) * inv_row
        neg = inv_row < 0.0
        near, far = torch.where(neg, t1, t0), torch.where(neg, t0, t1)
        lo = torch.where(near > lo, near, lo)
        hi = torch.where(far < hi, far, hi)
    return (hi >= lo).any(dim=1)


def pack_rays_tiles(o, d, t_max, t_lanes: int, t_min=1e-3) -> torch.Tensor:
    """[nt, 8, T] ray pack; N must be a multiple of t_lanes."""
    n = o.shape[0]
    nt = n // t_lanes
    flat = torch.cat([
        o.T, d.T, t_max[None],
        torch.full((1, n), t_min, dtype=torch.float32, device=o.device),
    ], dim=0)                                              # [8, N]
    return flat.reshape(RAY_ROWS, nt, t_lanes).transpose(0, 1).contiguous()


def mt_sweep_rows(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z,
                  e1x, e1y, e1z, e2x, e2y, e2z, t_min, t_max):
    """Möller–Trumbore on broadcast components, the reference's
    traverse._mt_sweep term for term (its counterpart in the port).
    Returns (t with inf where invalid, ok)."""
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = torch.abs(a) > MT_EPSILON
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    ok = ok & (t >= t_min) & (t <= t_max)
    return torch.where(ok, t, torch.full_like(t, float("inf"))), ok


PLAIN_ELEMS = 1 << 22  # [blocks, T, rows] elements per step of sweep_rows_plain


def sweep_rows_plain(tri_pack, cid, rays, lo: int, hi: int, t_max=None,
                     any_hit: bool = False, tie: str = "tri"):
    """Blocks of T rays against slots lo..hi-1 of ONE cluster each (cid [n]
    i64) or of G clusters each (cid [n, G], one reduction over their G *
    (hi - lo) slots), in eager torch: tri_pack [C, >=10, S], rays [n, 8, T];
    t_max [n, T] replaces ray row 6. Returns (best t [n, T], min tri id at
    best t [n, T] i32, INT32_MAX on a miss), or with any_hit the [n, T] bool
    "some slot passes"; tie="slot": the id of the first slot at the best t
    (argmin over the slots in (cluster, triangle) order; INT32_MAX where
    the best t is inf). Chunked so the [blocks, T, rows] temporaries stay
    small."""
    n, _, t_lanes = rays.shape
    dev = rays.device
    if cid.dim() == 1:
        cid = cid[:, None]
    g = cid.shape[1]
    step = max(1, PLAIN_ELEMS // (t_lanes * max(hi - lo, 1) * g))
    hit = torch.empty((n, t_lanes), dtype=torch.bool, device=dev)
    t_out = torch.empty((n, t_lanes), dtype=torch.float32, device=dev)
    tri_out = torch.empty((n, t_lanes), dtype=torch.int32, device=dev)
    for a in range(0, n, step):
        b = min(a + step, n)
        tp = tri_pack[cid[a:b], :, lo:hi]                  # [c, g, rows, w]
        tp = tp.transpose(1, 2).reshape(b - a, tri_pack.shape[1], -1)
        rp = rays[a:b]
        ray = [rp[:, k, :, None] for k in range(RAY_ROWS)]  # [c, T, 1]
        tri = [tp[:, k, None, :] for k in range(9)]         # [c, 1, w]
        cap = ray[6] if t_max is None else t_max[a:b, :, None]
        tt, ok = mt_sweep_rows(*ray[:6], *tri, ray[7], cap)
        if any_hit:
            hit[a:b] = ok.any(dim=-1)
            continue
        tid = tp[:, 9, None, :].view(torch.int32)
        if tie == "slot":
            slot = torch.argmin(tt, dim=-1, keepdim=True)  # the first minimum
            best = torch.gather(tt, 2, slot).squeeze(2)
            first = torch.gather(tid.expand(tt.shape), 2, slot).squeeze(2)
            t_out[a:b] = best
            tri_out[a:b] = torch.where(best < INF, first, I32_MAX)
            continue
        best = tt.amin(dim=-1)
        t_out[a:b] = best
        tri_out[a:b] = torch.where(ok & (tt <= best[..., None]), tid,
                                   I32_MAX).amin(dim=-1).to(torch.int32)
    return hit if any_hit else (t_out, tri_out)


def sub_slab_ranges(s: int, sub_skip: bool):
    """Slot ranges one cluster is swept in: its sub-slabs under sub_skip,
    else the whole cluster."""
    if not sub_skip:
        return [(0, s)]
    return [(k * SUB, min((k + 1) * SUB, s)) for k in range(n_subs(s))]


def tile_sweep_plain(tri_pack, rays_pack, tile_cid, sub_skip=False,
                     pack_t=False, stats: Optional[dict] = None,
                     tie: str = "tri"):
    """The kernel's function in eager torch: the [tiles, T, G * S] sweep
    plus the min / min-tri-at-min reduction (tie="slot": the first slot at
    the min, sweep_rows_plain's), chunked over tiles. tile_cid [nt] or
    [nt, G]. pack_t: tri_pack is [C, S, 16] (read through its
    transpose). sub_skip: each cluster in sub-slabs, with a tile-uniform
    gate (a sub-slab is swept for the tiles where some lane's [t_min,
    min(t_max, running best)] segment touches its box; the kernel votes per
    warp, so it sweeps a subset of these, to the same bits). stats["tests"]
    counts the ray/triangle tests of the sweeps made here over all T lanes,
    stats["lane_tests"] those of their live lanes (t_max >= 0)."""
    _check_options(sub_skip, pack_t, tie)
    if pack_t:
        tri_pack = tri_pack.transpose(1, 2)
    nt, _, t_lanes = rays_pack.shape
    s = tri_pack.shape[2]
    cid = tile_cid.long()
    if cid.dim() == 1:
        cid = cid[:, None]
    if not sub_skip:
        if stats is not None:
            swept = s * cid.shape[1]
            live = int((rays_pack[:, 6] >= 0.0).sum())
            stats["tests"] = stats.get("tests", 0) + nt * t_lanes * swept
            stats["lane_tests"] = stats.get("lane_tests", 0) + live * swept
        return sweep_rows_plain(tri_pack, cid, rays_pack, 0, s, tie=tie)
    dev = rays_pack.device
    best_t = torch.full((nt, t_lanes), float("inf"), dtype=torch.float32,
                        device=dev)
    best_tri = torch.full((nt, t_lanes), I32_MAX, dtype=torch.int32,
                          device=dev)
    inv = 1.0 / rays_pack[:, 3:6]
    live_per_tile = (rays_pack[:, 6] >= 0.0).sum(dim=1)
    tests = 0
    lane_tests = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(cid.shape[1]):
        cj = cid[:, j]
        for k, (lo, hi) in enumerate(sub_slab_ranges(s, True)):
            cap = torch.minimum(rays_pack[:, 6], best_t)
            go = sub_pred(tri_pack[cj, 10:16, k], rays_pack, inv,
                          rays_pack[:, 7], cap)
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                continue
            tests += idx.numel() * t_lanes * (hi - lo)
            if stats is not None:
                lane_tests += live_per_tile[idx].sum() * (hi - lo)
            kt, ktri = sweep_rows_plain(tri_pack, cj[idx], rays_pack[idx],
                                        lo, hi, t_max=cap[idx])
            best_t[idx], best_tri[idx] = combine_min_tri(
                best_t[idx], best_tri[idx], kt, ktri)
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests
        stats["lane_tests"] = stats.get("lane_tests", 0) + int(lane_tests)
    return best_t, best_tri


def _check_options(sub_skip, pack_t, tie):
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, not {tie!r}")
    if sub_skip and pack_t:
        raise ValueError("sub_skip reads the [C, 16, S] pack; pack_t cannot "
                         "be combined with it")
    if tie == "slot" and (sub_skip or pack_t):
        raise ValueError("the first-slot instance takes neither sub_skip "
                         "nor pack_t")


def _check(name, x, dtype, ndim, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {ndim} dims")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel():
    lib = cuda_build.load(SOURCE)
    fn = lib.ctiles_sweep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_first():
    fn = cuda_build.load(SOURCE).ctiles_sweep_first
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_options():
    fn = cuda_build.load(SOURCE).ctiles_sweep_options
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# ctiles_sweep_options' `mode`: which option the instance compiles in
# (MODE_FIRST: ctiles_sweep_first's, through the generic instance only).
MODE_SUB_SKIP = 1
MODE_PACK_T = 2
MODE_FIRST = 3


def read_occupancy(fn, *shape) -> dict:
    """Registers per thread and resident warps per SM of a compiled kernel
    instance, through its `<name>_occupancy` entry point (needs the card)."""
    regs, warps = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(*shape, ctypes.byref(regs), ctypes.byref(warps))
    if err != 0:
        raise RuntimeError(f"occupancy query {shape} failed: cudaError {err}")
    return {"registers": regs.value, "warps_per_sm": warps.value}


def rcp_mismatches() -> int:
    """How many of the float bit patterns in its range the kernels'
    reciprocal (csrc/mt.cuh rcp_fast) inverts to other bits than the IEEE
    division does: 0 on a card where the kernels are exact. Needs the card."""
    fn = cuda_build.load(SOURCE).rcp_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros((1,), dtype=torch.int64, device="cuda")
    err = cuda_build.launch(fn, count.device, count.data_ptr())
    if err != 0:
        raise RuntimeError(f"rcp_check launch failed: cudaError {err}")
    return int(count.item())


def kernel_occupancy(s: int, t_lanes: int, sub_skip: bool = False,
                     pack_t: bool = False, tie: str = "tri") -> dict:
    """tile_sweep's (S, T) instance, or its sub_skip / pack_t / first-slot
    instance (needs the card)."""
    lib = cuda_build.load(SOURCE)
    if tie == "slot":
        return read_occupancy(lib.ctiles_sweep_first_occupancy, s, t_lanes)
    if not (sub_skip or pack_t):
        return read_occupancy(lib.ctiles_sweep_occupancy, s, t_lanes)
    return read_occupancy(lib.ctiles_sweep_options_occupancy, s, t_lanes,
                          MODE_SUB_SKIP if sub_skip else MODE_PACK_T)


def _kernel_generic():
    fn = cuda_build.load(SOURCE).ctiles_sweep_generic
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tile_sweep(tri_pack, rays_pack, tile_cid, sub_skip=False, pack_t=False,
               tie: str = "tri"):
    """(t [nt, T] f32, tri [nt, T] i32); tri = INT32_MAX on a miss.

    tile_cid [nt] (one cluster a tile) or [nt, G] (tile i against its G
    clusters, folded with the lexicographic (t, min tri) rule, or with
    tie="slot" by the first slot at the minimum t). tri_pack is
    pack_tris' [C, 10, S]; with sub_skip pack_tris16's [C, 16, S], with
    pack_t pack_tris16_t's [C, S, 16] (the two options together raise
    ValueError). CUDA tensors launch the kernel (or raise): its tuned
    instance where one is compiled for (S, T), else its generic instance,
    which takes any S and T; CPU tensors take the plain version. tile_cid
    values must lie in [0, C)."""
    global launches, generic_launches, slot_launches
    _check_options(sub_skip, pack_t, tie)
    dev = rays_pack.device
    if dev.type == "cpu":
        return tile_sweep_plain(tri_pack, rays_pack, tile_cid, sub_skip,
                                pack_t, tie=tie)
    if dev.type != "cuda":
        raise ValueError(f"tile_sweep runs on cuda or cpu, not {dev}")
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays_pack", rays_pack, torch.float32, 3, dev)
    if pack_t:
        c, s, rows = tri_pack.shape
    else:
        c, rows, s = tri_pack.shape
    nt, ray_rows, t_lanes = rays_pack.shape
    want_rows = 16 if (sub_skip or pack_t) else PACK_ROWS
    if rows != want_rows or ray_rows != RAY_ROWS:
        layout = ("[C,S,16]" if pack_t else "[C,16,S]" if sub_skip
                  else "[C,10,S]")
        raise ValueError(f"pack shapes {tuple(tri_pack.shape)} / "
                         f"{tuple(rays_pack.shape)} are not {layout} / "
                         "[nt,8,T]")
    g = tile_cid.shape[1] if tile_cid.dim() == 2 else 1
    if tile_cid.dim() not in (1, 2) or tile_cid.shape[0] != nt or g < 1:
        raise ValueError(f"tile_cid has shape {tuple(tile_cid.shape)}, "
                         f"expected [{nt}] or [{nt}, G >= 1]")
    _check("tile_cid", tile_cid, torch.int32, tile_cid.dim(), dev)
    if s < 1 or t_lanes < 1:
        raise ValueError(f"tile_sweep needs S >= 1 and T >= 1, not S = {s}, "
                         f"T = {t_lanes}")
    t_out = torch.empty((nt, t_lanes), dtype=torch.float32, device=dev)
    tri_out = torch.empty((nt, t_lanes), dtype=torch.int32, device=dev)
    if nt == 0:
        return t_out, tri_out
    args = (tri_pack.data_ptr(), rays_pack.data_ptr(), tile_cid.data_ptr(),
            t_out.data_ptr(), tri_out.data_ptr(), nt, g, s, t_lanes, c)
    first = tie == "slot"
    mode = (MODE_SUB_SKIP if sub_skip else MODE_PACK_T if pack_t
            else MODE_FIRST if first else 0)
    tuned = (_kernel_first() if first else _kernel_options() if mode
             else _kernel())
    err, ran_generic = cuda_build.launch_instance(
        tuned, _kernel_generic(), dev,
        args + ((mode,) if sub_skip or pack_t else ()),
        generic_args=args + (mode,))
    if err != 0:
        raise RuntimeError(f"ctiles_sweep launch failed: cudaError {err}")
    option = ("sub_skip" if sub_skip else "pack_t" if pack_t
              else "slot" if first else None)
    key = ((t_lanes, s, g) + ((option,) if option else ())
           + (("generic",) if ran_generic else ()))
    with sync.lock:
        launches += 1
        generic_launches += ran_generic
        slot_launches += first
        shape = launch_shapes.setdefault(key, [0, 0])
        shape[0] += 1
        shape[1] += nt
    return t_out, tri_out


# ---- block_cull: ctiles' flat cull (csrc/ctiles_cull.cu) -------------------


def block_cull_plain(accel, o_blk, d_blk, tm_blk, t_min, cap,
                     live_blocks=None, row_chunk=1 << 11, levels=1,
                     super_cap=48):
    """block_cull in eager torch: at levels 1 accel.ctiles' _ray_masks and
    _extract_order_flat, at levels 2 its _block_candidates_2level, in row
    chunks up to the live-block count (read on the host: the CPU has no
    queue to drain). Blocks at or past the count get the empty set whatever
    their rays, as in the kernel (order C - 1, n_cand 0, over False; JAX's
    2-level cull leaves zeros in the rows past its last chunk, which no
    caller reads)."""
    from path_tracer_ai_tpu_torch.accel import ctiles

    lb = None if live_blocks is None else int(live_blocks)
    if lb is not None:
        past = torch.arange(o_blk.shape[0], device=o_blk.device) >= lb
        tm_blk = torch.where(past[:, None], -1.0, tm_blk)
    if levels == 2:
        order, n_cand, over = ctiles._block_candidates_2level(
            accel, o_blk, d_blk, tm_blk, t_min, cap, row_chunk, super_cap,
            live_blocks=lb)
        if lb is not None:
            order = torch.where(past[:, None], accel.num_clusters - 1, order)
        return order, n_cand, over
    cand, n_cand = ctiles._ray_masks(accel, o_blk, d_blk, tm_blk, t_min,
                                     row_chunk, live_blocks=lb)
    return ctiles._extract_order_flat(accel, cand, n_cand, cap,
                                      row_chunk=row_chunk)


def _cull_kernel(levels=1):
    lib = cuda_build.load(CULL_SOURCE)
    if levels == 2:
        fn = lib.block_cull_2level
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 7
                           + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
        return fn
    fn = lib.block_cull
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def cull_occupancy(b: int, levels: int = 1, super_cap: int = 48) -> dict:
    """block_cull's registers and resident warps per SM at b rays a block
    (at levels 2 with a list of super_cap supers a warp; needs the card)."""
    lib = cuda_build.load(CULL_SOURCE)
    if levels == 2:
        return read_occupancy(lib.block_cull2_occupancy, b, super_cap)
    return read_occupancy(lib.block_cull_occupancy, b)


def block_cull(accel, o_blk, d_blk, tm_blk, t_min, cap, live_blocks=None,
               levels=1, super_cap=48):
    """Per-ray inclusive slab cull, OR'd per block of b rays, and each
    block's first candidates ascending -> (order [nb, kx] i32, C - 1 past
    n_cand; n_cand [nb] i32, 0 where the block overflows; over [nb] bool).

    levels 1: every cluster box (accel.bmin / bmax), kx = min(cap, C), a
    block overflows past cap candidates. levels 2: the block's supers
    (accel.sbmin / sbmax) in kslots' rule, then the children (accel.cbmin /
    cbmax) of its first scap = min(super_cap, Cs) in the comparison-select
    rule; kx = min(cap, scap * super_size, C), a block overflows past scap
    supers or kx children (the kernel keeps b rays and scap supers a warp
    in 6 KiB of shared memory, and refuses the launch past that).

    o_blk / d_blk [nb, b, 3], tm_blk [nb, b] (negative: dead). live_blocks:
    None (every block), or a one-element i32 tensor on the blocks' device,
    the blocks that can hold live rays (waves sorted dead-last); blocks
    past it get the empty set, which their dead rays give anyway. CUDA
    tensors launch csrc/ctiles_cull.cu, which reads live_blocks on the
    device (or raise); CPU tensors take block_cull_plain."""
    global cull_launches, cull2_launches
    if levels not in (1, 2):
        raise ValueError(f"block_cull takes levels 1 or 2, not {levels}")
    dev = o_blk.device
    if dev.type == "cpu":
        return block_cull_plain(accel, o_blk, d_blk, tm_blk, t_min, cap,
                                live_blocks, levels=levels,
                                super_cap=super_cap)
    if dev.type != "cuda":
        raise ValueError(f"block_cull runs on cuda or cpu, not {dev}")
    nb, b = o_blk.shape[:2]
    c = accel.num_clusters
    o_blk, d_blk = o_blk.contiguous(), d_blk.contiguous()
    tm_blk = tm_blk.contiguous()
    _check("o_blk", o_blk, torch.float32, 3, dev)
    _check("d_blk", d_blk, torch.float32, 3, dev)
    _check("tm_blk", tm_blk, torch.float32, 2, dev)
    if levels == 1:
        boxes = (accel.bmin.contiguous(), accel.bmax.contiguous())
        names, dims = ("bmin", "bmax"), (2, 2)
    else:
        boxes = tuple(x.contiguous() for x in (accel.sbmin, accel.sbmax,
                                                accel.cbmin, accel.cbmax))
        names, dims = ("sbmin", "sbmax", "cbmin", "cbmax"), (2, 2, 3, 3)
    for name, x, nd in zip(names, boxes, dims):
        _check(name, x, torch.float32, nd, dev)
    if (o_blk.shape[2] != 3 or d_blk.shape != o_blk.shape
            or tuple(tm_blk.shape) != (nb, b)
            or any(x.shape[-1] != 3 for x in boxes)
            or boxes[1].shape != boxes[0].shape
            or (levels == 1 and tuple(boxes[0].shape) != (c, 3))
            or (levels == 2 and (boxes[2].shape[0] != boxes[0].shape[0]
                                 or boxes[3].shape != boxes[2].shape
                                 or boxes[2].shape[0] * boxes[2].shape[1]
                                 < c))):
        raise ValueError("block_cull takes o_blk / d_blk [nb, b, 3], tm_blk "
                         "[nb, b] and boxes [C, 3] (levels 1) or supers "
                         "[Cs, 3] and children [Cs, ss, 3] (levels 2)")
    if b < 1 or b > 192 or cap < 1 or (levels == 2 and super_cap < 1):
        raise ValueError(f"block_cull takes 1 <= b <= 192 rays a block, cap "
                         f">= 1 and super_cap >= 1, not b = {b}, cap = "
                         f"{cap}, super_cap = {super_cap}")
    if levels == 2:
        cs, ss = boxes[2].shape[:2]
        scap = min(super_cap, cs)
        kx = min(cap, scap * ss, c)
    else:
        kx = min(cap, c)
    if live_blocks is not None:
        if (live_blocks.device != dev or live_blocks.dtype != torch.int32
                or live_blocks.numel() != 1):
            raise ValueError("live_blocks must be one i32 on the blocks' "
                             "device")
    order = torch.empty((nb, kx), dtype=torch.int32, device=dev)
    n_cand = torch.empty((nb,), dtype=torch.int32, device=dev)
    over = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb == 0:
        return order, n_cand, over
    live = None if live_blocks is None else live_blocks.data_ptr()
    rays = (o_blk.data_ptr(), d_blk.data_ptr(), tm_blk.data_ptr())
    outs = (order.data_ptr(), n_cand.data_ptr(), over.data_ptr())
    if levels == 2:
        err = cuda_build.launch(
            _cull_kernel(2), dev, *rays, *(x.data_ptr() for x in boxes),
            float(t_min), live, nb, b, c, cs, ss, scap, kx, *outs)
    else:
        err = cuda_build.launch(
            _cull_kernel(), dev, *rays, *(x.data_ptr() for x in boxes),
            float(t_min), live, nb, b, c, cap, kx, *outs)
    if err != 0:
        raise RuntimeError(f"block_cull launch failed: cudaError {err}")
    with sync.lock:
        if levels == 2:
            cull2_launches += 1
        else:
            cull_launches += 1
    return order, n_cand, over


# ---- slot_sweep: the sweep over static slot tables (csrc/ctiles_sweep.cu) --

SLOT_OUTS = {"closest": 0, "any": 1, "slot": 2}
# the closest fold's start: (inf, INT32_MAX) as the kernel's 64-bit key
# (order_key(inf) << 32 | INT32_MAX ^ 2^31), as a signed i64
FOLD_MISS_KEY = ((0xFF800000 << 32) | 0xFFFFFFFF) - (1 << 64)


def slot_sweep_plain(tri_pack, ray_table, slot_ref, tile_cid, n_tiles, *,
                     tile_slots, cap, out, cid_stride=1, sub_skip=False,
                     pack_t=False, tile_chunk=256, sweep=None):
    """slot_sweep in chunks of `tile_chunk` live tiles (None: all in one),
    each gathered into a [tc, 8, T] ray pack and swept by `sweep` (None:
    this module's tile_sweep, looked up at the call: on CPU tensors its
    plain version, on CUDA tensors its kernel, the chunked form slot_sweep
    replaced), then resolved by row scatters: closest, the row's least t
    (-0.0 taken as +0.0), then the least tri among the slots at it; any
    hit, the max of tri != INT32_MAX. The live tile count is read on the
    host."""
    sweep = tile_sweep if sweep is None else sweep
    rows, _, b = ray_table.shape
    rows -= 1
    tb = tile_slots
    t_lanes = tb * b
    dev = ray_table.device
    nt_cap = slot_ref.shape[0] // tb
    nt = max(0, min(int(n_tiles), nt_cap))
    step = nt if tile_chunk is None else tile_chunk
    kw = {k: True for k, on in (("sub_skip", sub_skip), ("pack_t", pack_t))
          if on}

    def chunks():
        for start in range(0, nt, max(step, 1)):
            stop = min(start + step, nt)
            tc = stop - start
            sp = slot_ref[start * tb:stop * tb]
            row = torch.where(sp >= 0, sp // cap, rows).to(torch.int64)
            rays_pack = (ray_table[row].reshape(tc, tb, RAY_ROWS, b)
                         .transpose(1, 2).reshape(tc, RAY_ROWS, t_lanes)
                         .contiguous())
            cid = tile_cid[start * cid_stride:stop * cid_stride:cid_stride]
            ct, ctri = sweep(tri_pack, rays_pack, cid.contiguous(), **kw)
            yield start, stop, row[:, None].expand(-1, b), ct, ctri

    if out == "slot":
        t_out = torch.full((nt_cap * t_lanes,), INF, dtype=torch.float32,
                           device=dev)
        tri_out = torch.full((nt_cap * t_lanes,), I32_MAX, dtype=torch.int32,
                             device=dev)
        for start, stop, _row, ct, ctri in chunks():
            t_out[start * t_lanes:stop * t_lanes] = ct.reshape(-1)
            tri_out[start * t_lanes:stop * t_lanes] = ctri.reshape(-1)
        return t_out, tri_out
    if out == "any":
        occ = torch.zeros((rows + 1, b), dtype=torch.int32, device=dev)
        for _start, _stop, row, _ct, ctri in chunks():
            occ.scatter_reduce_(0, row, (ctri.reshape(-1, b) != I32_MAX).to(
                torch.int32), "amax")
        return (occ[:rows] > 0,)
    # Pass 1: the row's least t; row `rows` is the padding slots' sink.
    t_row = torch.full((rows + 1, b), INF, dtype=torch.float32, device=dev)
    kept = []
    for _start, _stop, row, ct, ctri in chunks():
        ct, ctri = ct.reshape(-1, b), ctri.reshape(-1, b)
        t_row.scatter_reduce_(0, row, ct, "amin")
        kept.append((row, ct, ctri))
    # Pass 2: the least tri id among the slots at the row's t.
    tri_row = torch.full((rows + 1, b), I32_MAX, dtype=torch.int32,
                         device=dev)
    for row, ct, ctri in kept:
        keep = ct <= torch.gather(t_row, 0, row)
        tri_row.scatter_reduce_(0, row, torch.where(keep, ctri, I32_MAX),
                                "amin")
    t_row = t_row[:rows]
    return torch.where(t_row == 0.0, 0.0, t_row), tri_row[:rows]


def _slot_kernel(name: str):
    fn = getattr(cuda_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def slot_occupancy(s: int, t_lanes: int, sub_skip: bool = False,
                   pack_t: bool = False) -> dict:
    """slot_sweep's (S, T) instance with its option, or (s = 0) its generic
    instance of that option (needs the card)."""
    mode = MODE_SUB_SKIP if sub_skip else MODE_PACK_T if pack_t else 0
    return read_occupancy(cuda_build.load(SOURCE).slot_sweep_occupancy, s,
                          t_lanes, mode)


def slot_sweep(tri_pack, ray_table, slot_ref, tile_cid, n_tiles, *,
               tile_slots, cap, out, cid_stride=1, sub_skip=False,
               pack_t=False):
    """Tiles of static slot tables swept against one cluster each, with
    the tile count on the device.

    ray_table [rows + 1, 8, b] f32 (rows ox oy oz dx dy dz t_max t_min of
    b lanes; row `rows` is dead: o 0, d 1, t_max -1); slot_ref [nt_cap *
    tile_slots] i32, slot p's ray row p // cap, -1 for padding (the dead
    row); tile i's cluster tile_cid[i * cid_stride] (i32); n_tiles: a
    one-element i32 tensor, the live tiles (tiles past it are not swept).
    Tile i's T = tile_slots * b lanes are the b lanes of the rows of its
    slots, in slot order. tri_pack and sub_skip / pack_t as tile_sweep's.

    out "closest": per row lane, (t [rows, b], tri [rows, b]), the
    lexicographic (t, tri) minimum over every slot of the row, (inf,
    INT32_MAX) where none passes; "any": (occluded [rows, b] bool,); "slot":
    per slot lane (t [nt_cap * T], tri), tile_sweep's, (inf, INT32_MAX)
    past the live tiles. CUDA tensors launch the kernel (its tuned
    instance for (S, T) where one is compiled, else the generic one) with
    no host read, or raise; CPU tensors take slot_sweep_plain."""
    global sweep_launches, sweep_generic_launches
    _check_options(sub_skip, pack_t, "tri")
    if out not in SLOT_OUTS:
        raise ValueError(f"out must be one of {tuple(SLOT_OUTS)}, not "
                         f"{out!r}")
    dev = ray_table.device
    if dev.type == "cpu":
        return slot_sweep_plain(tri_pack, ray_table, slot_ref, tile_cid,
                                n_tiles, tile_slots=tile_slots, cap=cap,
                                out=out, cid_stride=cid_stride,
                                sub_skip=sub_skip, pack_t=pack_t)
    if dev.type != "cuda":
        raise ValueError(f"slot_sweep runs on cuda or cpu, not {dev}")
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("ray_table", ray_table, torch.float32, 3, dev)
    _check("slot_ref", slot_ref, torch.int32, 1, dev)
    _check("tile_cid", tile_cid, torch.int32, 1, dev)
    if (n_tiles.device != dev or n_tiles.dtype != torch.int32
            or n_tiles.numel() != 1):
        raise ValueError("n_tiles must be one i32 on the tables' device")
    if pack_t:
        c, s, rows16 = tri_pack.shape
    else:
        c, rows16, s = tri_pack.shape
    want_rows = 16 if (sub_skip or pack_t) else PACK_ROWS
    n_rows, ray_rows, b = ray_table.shape
    rows = n_rows - 1
    tb = tile_slots
    if rows16 != want_rows or ray_rows != RAY_ROWS or rows < 0:
        raise ValueError(f"pack / ray table shapes {tuple(tri_pack.shape)} "
                         f"/ {tuple(ray_table.shape)} do not fit")
    if tb < 1 or cap < 1 or cid_stride < 1 or slot_ref.shape[0] % tb:
        raise ValueError(f"{slot_ref.shape[0]} slots are not whole tiles of "
                         f"{tb} (cap {cap}, cid_stride {cid_stride})")
    nt_cap = slot_ref.shape[0] // tb
    if nt_cap and tile_cid.shape[0] <= (nt_cap - 1) * cid_stride:
        raise ValueError(f"tile_cid holds {tile_cid.shape[0]} entries, "
                         f"fewer than {nt_cap} tiles at stride {cid_stride}")
    t_lanes = tb * b
    key = occ = t_out = tri_out = None
    if out == "closest":
        key = torch.full((max(rows * b, 1),), FOLD_MISS_KEY,
                         dtype=torch.int64, device=dev)
        t_out = torch.empty((rows, b), dtype=torch.float32, device=dev)
        tri_out = torch.empty((rows, b), dtype=torch.int32, device=dev)
    elif out == "any":
        occ = torch.zeros((rows, b), dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty((nt_cap * t_lanes,), dtype=torch.float32,
                            device=dev)
        tri_out = torch.empty((nt_cap * t_lanes,), dtype=torch.int32,
                              device=dev)
    mode = MODE_SUB_SKIP if sub_skip else MODE_PACK_T if pack_t else 0

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (tri_pack.data_ptr(), ray_table.data_ptr(), slot_ref.data_ptr(),
            tile_cid.data_ptr(), n_tiles.data_ptr(), ptr(key), ptr(occ),
            ptr(t_out), ptr(tri_out), nt_cap, tb, b, rows, cap, cid_stride,
            c, s, t_lanes, SLOT_OUTS[out], mode)
    err, ran_generic = cuda_build.launch_instance(
        _slot_kernel("slot_sweep"), _slot_kernel("slot_sweep_generic"), dev,
        args)
    if err != 0:
        raise RuntimeError(f"slot_sweep launch failed: cudaError {err}")
    option = "sub_skip" if sub_skip else "pack_t" if pack_t else None
    key_shape = ((t_lanes, s, out) + ((option,) if option else ())
                 + (("generic",) if ran_generic else ()))
    with sync.lock:
        sweep_launches += 1
        sweep_generic_launches += ran_generic
        shape = sweep_shapes.setdefault(key_shape, [0, 0])
        shape[0] += 1
        shape[1] += nt_cap
    if out == "any":
        return (occ,)
    return t_out, tri_out
