"""One stage of the packet cascade: a hand-written CUDA kernel and its plain
version.

Replaces no Pallas kernel: it carries the loop of the JAX package's
`_cascade_traverse` (path_tracer_ai_tpu/accel/traverse.py:439-520), a
`jax.lax.while_loop` a stage whose condition XLA evaluates on the device,
for `any_hit_packets` and `closest_hit_packets` (accel.traverse). One call
runs one stage to its end on a slice of ray blocks, as one while_loop does:

    loop: act = the active rule at k for every block of the slice;
          stop when sum(act) <= threshold; sweep group k; k += 1

and returns (carry, k, act), carry and k updated in place, act the rule at
the final k (the compaction between stages reads it). Two folds:

- any hit (entry None): carry (occ [size, T] bool,); act = k g < n_cand and
  some lane neither occluded nor dead (t_max < 0); the sweep set is act, its
  lanes occluded earlier go in dead; occ |= some test passes (traverse.py:
  940-955);
- first-slot closest (entry [size, >= K g] f32, the blocks' conservative
  entries): carry (best_t [size, T] f32, best_id [size, T] i32); act = k g <
  n_cand and entry[:, k g] <= the largest best t of a live lane; the sweep
  set is every block with k g < n_cand, the ones the entry rule retired
  while the stage runs on included (traverse.py:812-845); lanes swept with
  t_max = min(t_max, best t); (min t, first slot at it), kept where
  t < best t.

On a CUDA tensor `cascade_stage` launches csrc/ctiles_sweep.cu's stage
kernel (cooperative: the loop, its count and k stay on the card; tuned at
(T 64, S 128) and (T 256, S 128), every other S, T >= 1 through its generic
instance; a failed launch raises, there is no fallback). The kernel sweeps
only the blocks still on its list, and splits each 32-lane slot's group
over W warps, W = split_warps(...) from the stage's size and the
instance's resident warps (W = 1 where the stage fills the card; the same
bits at every W). On a CPU tensor it
runs `cascade_stage_plain`: the same loop in eager torch, one host read a
vote, each iteration's sweep one call of `sweep` (tile_sweep's plain
version). `cascade_stage_plain(..., sweep=cuda_ctiles.tile_sweep)` on CUDA
tensors is the host-stepped loop the card ran before the kernel: one
tile_sweep launch an iteration and one host read a vote (and one a sweep
set of the closest fold).

Layouts: tri_pack [C, 10, S] (cuda_ctiles.pack_tris); rays [size, 8, T]
(traverse.pack_block_rays: row 6 t_max, < 0 dead; row 7 t_min); order_g
[size, K, g] i32; n_cand [size] i32; k [1] i32.
"""

from __future__ import annotations

import ctypes

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import _check, read_occupancy
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
SOURCE = "ctiles_sweep"
NAMES = {True: "cascade_stage_any", False: "cascade_stage_first"}

# W, the warps the stage kernel gives a slot of 32 lanes (split_warps),
# and the rule's constant.
SPLITS = (1, 2, 4, 8)
SPLIT_K2 = 16

# Kernel launches since the last reset (the plain version never counts),
# those of the generic instance among them, by fold, and by shape:
# (fold, T, S, G, W) -> [launches, blocks], with "generic" as a further
# element where the generic instance ran. Updated under sync.lock.
launches = {name: 0 for name in NAMES.values()}
generic_launches = {name: 0 for name in NAMES.values()}
launch_shapes: dict = {}


def reset_launches() -> None:
    with sync.lock:
        for name in launches:
            launches[name] = generic_launches[name] = 0
        launch_shapes.clear()


def cascade_stage_plain(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                        entry=None, sweep=None, stats=None):
    """The stage kernel's function in eager torch (see the module): a host
    loop, one host read of the active count a vote; each iteration's sweep
    is one call sweep(tri_pack, rays [n, 8, T], cid [n, g], ...) over the
    sweep set (default cuda_ctiles.tile_sweep_plain; tile_sweep launches
    the kernel). stats, if given, gains "sweeps" (iterations), "blocks"
    (blocks swept, over the iterations), "tests" (live lane x g x S tests
    of the sweeps), "clusters" ([C] bool, the clusters swept) and "active"
    (the active blocks at each vote, in order)."""
    sweep = sweep or cuda_ctiles.tile_sweep_plain
    _size, kgroups, g = order_g.shape
    last = kgroups - 1
    tb = rays[:, 6]
    kv = sync.host_int(k)
    any_hit = entry is None

    def swept(r_act, cid):
        if stats is not None:
            live = int((r_act[:, 6] >= r_act[:, 7]).sum())
            stats["sweeps"] = stats.get("sweeps", 0) + 1
            stats["blocks"] = stats.get("blocks", 0) + r_act.shape[0]
            stats["tests"] = (stats.get("tests", 0)
                              + live * g * tri_pack.shape[2])
            mask = stats.setdefault("clusters", torch.zeros(
                tri_pack.shape[0], dtype=torch.bool, device=cid.device))
            mask[cid.reshape(-1).long()] = True
        return sweep(tri_pack, r_act, cid, **({} if any_hit
                                               else {"tie": "slot"}))

    while True:
        if any_hit:
            (occ,) = carry
            act = (kv * g < n_cand) & ~(occ | (tb < 0.0)).all(dim=1)
        else:
            best_t, best_id = carry
            best_eff = torch.where(tb < 0.0, -INF, best_t)
            act = ((kv * g < n_cand)
                   & (entry[:, min(kv, last) * g] <= best_eff.amax(dim=1)))
        idx = torch.nonzero(act).squeeze(1)
        sync.note()
        if stats is not None:
            stats.setdefault("active", []).append(idx.numel())
        if idx.numel() <= threshold:
            break
        if any_hit:
            # lanes occluded in an earlier iteration go in dead
            r_act = rays[idx]
            r_act[:, 6].masked_fill_(occ[idx], -1.0)
            _t, tri = swept(r_act, order_g[idx, min(kv, last)])
            occ[idx] |= tri != cuda_ctiles.I32_MAX
        else:
            # the reference's blk_on: every block with candidates
            idx = torch.nonzero(kv * g < n_cand).squeeze(1)
            sync.note()
            bt = best_t[idx]
            r_act = rays[idx]
            r_act[:, 6] = torch.minimum(r_act[:, 6], bt)
            ct, gid = swept(r_act, order_g[idx, min(kv, last)])
            closer = ct < bt
            best_t[idx] = torch.where(closer, ct, bt)
            best_id[idx] = torch.where(closer, gid, best_id[idx])
        kv += 1
    k.fill_(kv)
    return carry, k, act


def split_warps(size: int, t_lanes: int, resident_warps: int,
                sms: int) -> int:
    """W, the warps the stage kernel gives each 32-lane slot of a stage of
    `size` blocks of t_lanes lanes on a card of `sms` SMs that holds
    resident_warps of the instance an SM: the largest W of SPLITS with
    W^2 x slots <= SPLIT_K2 x the card's warps, that is W about 4 x the
    square root of the card's warps over the stage's slots. A pass ends in
    a tail, its last slots run on a card that is mostly idle, whose length
    is a slot's latency, which W divides; each further warp a slot costs a
    little on every slot (more staging and combining, and any-hit tests
    past a lane's first hit), so the best W grows as the square root of
    warps over slots. SPLIT_K2 is fitted to the stages measured on the
    H100 (PERF.md §6). A stage whose slots number more than SPLIT_K2 / 4
    times the card's warps, so that every warp takes more than two a pass
    even at the stage's end, keeps W = 1."""
    slots = size * -(-t_lanes // 32)
    warps = resident_warps * sms
    w = 1
    for cand in SPLITS[1:]:
        if cand * cand * slots <= SPLIT_K2 * warps:
            w = cand
    return w


_resident: dict = {}  # (device, S, T, any hit) -> (resident warps an SM, SMs)


def _resident_warps(dev, s: int, t_lanes: int, any_hit: bool) -> tuple:
    """The resident warps an SM of the instance that launches for (S, T)
    (the generic one where no tuned one is compiled) and the card's SMs."""
    key = (dev, s, t_lanes, any_hit)
    if key not in _resident:
        fn = cuda_build.load(SOURCE).cascade_stage_occupancy
        regs, warps = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(s, t_lanes, int(any_hit), ctypes.byref(regs),
                     ctypes.byref(warps))
            if err == cuda_build.NO_INSTANCE:
                err = fn(0, 0, int(any_hit), ctypes.byref(regs),
                         ctypes.byref(warps))
        if err != 0:
            raise RuntimeError(f"cascade_stage_occupancy: cudaError {err}")
        _resident[key] = (warps.value,
                          torch.cuda.get_device_properties(
                              dev).multi_processor_count)
    return _resident[key]


def _kernel(generic: bool = False):
    lib = cuda_build.load(SOURCE)
    fn = lib.cascade_stage_generic if generic else lib.cascade_stage
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _work(size: int, dev) -> torch.Tensor:
    """The kernel's work buffer (csrc/ctiles_sweep.cu StageArgs): 14 words
    of grid counts, a vote and an arrival count a block, two lists of
    `size` blocks; zeros (one fill)."""
    return torch.zeros((14 + 4 * size,), dtype=torch.int32, device=dev)


def kernel_occupancy(s: int, t_lanes: int, any_hit: bool) -> dict:
    """The stage kernel's (S, T) instance (S = 0: the generic one):
    registers per thread and resident warps per SM (needs the card)."""
    return read_occupancy(cuda_build.load(SOURCE).cascade_stage_occupancy, s,
                          t_lanes, int(any_hit))


def cascade_stage(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                  entry=None):
    """One stage of the cascade to its end (see the module): (carry, k,
    act), carry and k updated in place. CUDA tensors launch the stage
    kernel (or raise); CPU tensors run cascade_stage_plain."""
    dev = rays.device
    if dev.type == "cpu":
        return cascade_stage_plain(tri_pack, rays, order_g, n_cand, carry, k,
                                   threshold, entry)
    if dev.type != "cuda":
        raise ValueError(f"cascade_stage runs on cuda or cpu, not {dev}")
    any_hit = entry is None
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays", rays, torch.float32, 3, dev)
    _check("order_g", order_g, torch.int32, 3, dev)
    _check("n_cand", n_cand, torch.int32, 1, dev)
    _check("k", k, torch.int32, 1, dev)
    c, rows, s = tri_pack.shape
    size, ray_rows, t_lanes = rays.shape
    _n, kgroups, g = order_g.shape
    if (rows != cuda_ctiles.PACK_ROWS or ray_rows != cuda_ctiles.RAY_ROWS
            or _n != size or n_cand.shape[0] != size or k.numel() != 1
            or kgroups < 1 or g < 1 or s < 1 or t_lanes < 1):
        raise ValueError(
            f"shapes tri_pack {tuple(tri_pack.shape)}, rays "
            f"{tuple(rays.shape)}, order_g {tuple(order_g.shape)}, n_cand "
            f"{tuple(n_cand.shape)}, k {tuple(k.shape)} are not [C,10,S], "
            "[size,8,T], [size,K,g], [size], [1]")
    if any_hit:
        (occ,) = carry
        _check("occ", occ, torch.bool, 2, dev)
        outs = (occ,)
        ptrs = (0, occ.data_ptr(), 0, 0)
        stride = 0
    else:
        best_t, best_id = carry
        _check("entry", entry, torch.float32, 2, dev)
        _check("best_t", best_t, torch.float32, 2, dev)
        _check("best_id", best_id, torch.int32, 2, dev)
        outs = (best_t, best_id)
        stride = entry.shape[1]
        if entry.shape[0] != size or stride < (kgroups - 1) * g + 1:
            raise ValueError(f"entry has shape {tuple(entry.shape)}, "
                             f"expected [{size}, >= {(kgroups - 1) * g + 1}]")
        ptrs = (entry.data_ptr(), 0, best_t.data_ptr(), best_id.data_ptr())
    if any(tuple(x.shape) != (size, t_lanes) for x in outs):
        raise ValueError(f"carry shapes {[tuple(x.shape) for x in outs]} "
                         f"are not [{size}, {t_lanes}]")
    act = torch.empty((size,), dtype=torch.bool, device=dev)
    if size == 0:
        return carry, k, act
    w = split_warps(size, t_lanes, *_resident_warps(dev, s, t_lanes,
                                                     any_hit))
    work = _work(size, dev)
    args = (tri_pack.data_ptr(), rays.data_ptr(), order_g.data_ptr(),
            n_cand.data_ptr(), *ptrs, k.data_ptr(), act.data_ptr(),
            work.data_ptr(), size, kgroups, g, s, t_lanes, c, stride,
            int(threshold), int(any_hit), w)
    err, ran_generic = cuda_build.launch_instance(
        _kernel(), _kernel(generic=True), dev, args)
    if err != 0:
        raise RuntimeError(f"cascade_stage launch failed: cudaError {err}")
    name = NAMES[any_hit]
    key = ((name, t_lanes, s, g, w) + (("generic",) if ran_generic else ()))
    with sync.lock:
        launches[name] += 1
        generic_launches[name] += ran_generic
        shape = launch_shapes.setdefault(key, [0, 0])
        shape[0] += 1
        shape[1] += size
    return carry, k, act
