"""The cluster-tile sweep: a hand-written CUDA kernel and its plain version.

Replaces path_tracer_ai_tpu/accel/pallas_ctiles.py `tile_sweep` (the
Pallas kernel `_sweep_kernel`/`_mt_rows`). `tile_sweep(tri_pack,
rays_pack, tile_cid)` tests each tile of T rays against ONE cluster's S
triangles and returns, per lane, the best t and the minimum triangle id
at that t (INT32_MAX on a miss). The same call serves the closest-hit
ctiles sweep (T = 128), the shadow cascade (T = 64; occluded =
tri != INT32_MAX) and the overflow fallback.

On a CUDA tensor the wrapper launches csrc/ctiles_sweep.cu (built with
nvcc at first use, see cuda_build) or raises; on a CPU tensor it runs
`tile_sweep_plain`, the same arithmetic as eager torch ops. The kernel's
design and its bound are described in the CUDA source.

Layouts:
  tri_pack [C, 10, S] f32 (pack_tris): v0.xyz, e1.xyz, e2.xyz, tri id
           bit-cast to f32. (The TPU pack's rows 10-15, sub-slab boxes for
           the `sub_skip` option, are not ported yet.)
  rays     [nt, 8, T] f32 (pack_rays_tiles): ox oy oz dx dy dz t_max t_min.
  tile_cid [nt] i32.
"""

from __future__ import annotations

import ctypes

import torch

from path_tracer_ai_tpu_torch.core.types import MT_EPSILON

I32_MAX = 2**31 - 1
PACK_ROWS = 10
RAY_ROWS = 8
SOURCE = "ctiles_sweep"

# Kernel launches since the last reset (the plain version never counts).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def pack_tris(accel) -> torch.Tensor:
    """[C, 10, S] f32 triangle pack of a ClusterAccel."""
    rows = [accel.v0[:, :, k] for k in range(3)]
    rows += [accel.e1[:, :, k] for k in range(3)]
    rows += [accel.e2[:, :, k] for k in range(3)]
    rows.append(accel.tri_id.view(torch.float32))
    return torch.stack(rows, dim=1).contiguous()


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


PLAIN_CHUNK = 64  # tiles per step of the plain version ([64, T, S] temporaries)


def tile_sweep_plain(tri_pack, rays_pack, tile_cid):
    """The kernel's function in eager torch: the [tiles, T, S] sweep plus
    the min / min-tri-at-min reduction, chunked over tiles."""
    nt, _, t_lanes = rays_pack.shape
    dev = rays_pack.device
    t_out = torch.empty((nt, t_lanes), dtype=torch.float32, device=dev)
    tri_out = torch.empty((nt, t_lanes), dtype=torch.int32, device=dev)
    for lo in range(0, nt, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, nt)
        tp = tri_pack[tile_cid[lo:hi].long()]             # [c, 10, S]
        rp = rays_pack[lo:hi]                             # [c, 8, T]
        ray = [rp[:, k, :, None] for k in range(RAY_ROWS)]  # [c, T, 1]
        tri = [tp[:, k, None, :] for k in range(9)]         # [c, 1, S]
        tt, ok = mt_sweep_rows(*ray[:6], *tri, ray[7], ray[6])
        best = tt.amin(dim=-1)                            # [c, T]
        tid = tp[:, 9, None, :].view(torch.int32)
        tri_min = torch.where(ok & (tt <= best[..., None]), tid,
                              I32_MAX).amin(dim=-1)
        t_out[lo:hi] = best
        tri_out[lo:hi] = tri_min.to(torch.int32)
    return t_out, tri_out


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
    from path_tracer_ai_tpu_torch import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.ctiles_sweep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tile_sweep(tri_pack, rays_pack, tile_cid):
    """(t [nt, T] f32, tri [nt, T] i32); tri = INT32_MAX on a miss.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. tile_cid values must lie in [0, C)."""
    global launches
    dev = rays_pack.device
    if dev.type == "cpu":
        return tile_sweep_plain(tri_pack, rays_pack, tile_cid)
    if dev.type != "cuda":
        raise ValueError(f"tile_sweep runs on cuda or cpu, not {dev}")
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays_pack", rays_pack, torch.float32, 3, dev)
    _check("tile_cid", tile_cid, torch.int32, 1, dev)
    c, rows, s = tri_pack.shape
    nt, ray_rows, t_lanes = rays_pack.shape
    if rows != PACK_ROWS or ray_rows != RAY_ROWS:
        raise ValueError(f"pack shapes {tuple(tri_pack.shape)} / "
                         f"{tuple(rays_pack.shape)} are not [C,10,S] / [nt,8,T]")
    if tile_cid.shape[0] != nt:
        raise ValueError(f"tile_cid has {tile_cid.shape[0]} tiles, rays {nt}")
    if not 0 < t_lanes <= 1024:
        raise ValueError(f"T = {t_lanes} lanes per tile is outside (0, 1024]")
    if PACK_ROWS * s * 4 > 48 * 1024:
        raise ValueError(f"S = {s} needs more than 48 KB of shared memory")
    t_out = torch.empty((nt, t_lanes), dtype=torch.float32, device=dev)
    tri_out = torch.empty((nt, t_lanes), dtype=torch.int32, device=dev)
    if nt == 0:
        return t_out, tri_out
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(tri_pack.data_ptr(), rays_pack.data_ptr(), tile_cid.data_ptr(),
             t_out.data_ptr(), tri_out.data_ptr(), nt, s, t_lanes, c, stream)
    if err != 0:
        raise RuntimeError(f"ctiles_sweep launch failed: cudaError {err}")
    launches += 1
    return t_out, tri_out
