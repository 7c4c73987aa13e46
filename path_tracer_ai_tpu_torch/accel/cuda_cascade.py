"""One stage of a cascade: a hand-written CUDA kernel and its plain
versions.

Replaces no Pallas kernel: it carries the loop of the JAX package's
`_cascade_traverse` (path_tracer_ai_tpu/accel/traverse.py:439-520), a
`jax.lax.while_loop` a stage whose condition XLA evaluates on the device,
for the packet cascades (`any_hit_packets`, `closest_hit_packets`:
accel.traverse), the fused cascades (`any_hit_fused`: accel.cuda_anyhit;
`closest_hit_fused`: accel.cuda_closest) and the perray queries
(`any_hit_perray`, `closest_hit_perray`: accel.traverse). One call runs
one stage to its end on a slice of ray blocks, as one while_loop does:

    loop: act = the active rule at k for every block of the slice;
          stop when sum(act) <= threshold; sweep group k; k += 1

and returns (carry, k, act), carry and k updated in place, act the rule at
the final k (the compaction between stages reads it). Six folds, one
counter table keyed by their names (`FOLDS`):

- cascade_stage_any, the packet any hit (entry None): carry (occ [size, T]
  bool,); act = k g < n_cand and some lane neither occluded nor dead
  (t_max < 0); the sweep set is act, its lanes occluded earlier go in dead;
  occ |= some test passes (traverse.py:940-955);
- cascade_stage_first, the packet first-slot closest (entry [size, >= K g]
  f32, the blocks' conservative entries): carry (best_t [size, T] f32,
  best_id [size, T] i32); act = k g < n_cand and entry[:, k g] <= the
  largest best t of a live lane; the sweep set is every block with k g <
  n_cand, the ones the entry rule retired while the stage runs on included
  (traverse.py:812-845); lanes swept with t_max = min(t_max, best t); (min
  t, first slot at it), kept where t < best t;
- fused_stage_any: the packet any hit's rule and sweep set with g = 8
  (cuda_anyhit.py's active_fn); the sweep is block_anyhit over group
  min(k, K - 1) with its early_skip and sub_skip gates, ORed into occ
  (pallas_anyhit.py:327-367);
- fused_stage_closest: the first-slot fold's rule and sweep set with g = 8
  (the JAX package's body sweeps its whole slice, pallas_closest.py:
  271-318); the sweep is block_closest with sub_skip on lanes capped at
  torch.minimum(t_max, best_t), combined into the carry by
  cuda_ctiles.combine_min_tri (the lexicographic (t, least tri) rule, the
  oracle's);
- perray_stage_any and perray_stage_first, the perray queries' folds
  (blocks of ONE ray, rays [size, 8, 1], carry [size, 1]; the JAX
  package's active_fn, traverse.py:648-665, 727-738): any hit, act = k g
  < n_cand and not occluded; closest, act = k g < n_cand and t_max >= 0
  (no entry rule: the candidates come in id order). The sweep set is act;
  the sweep is the per-ray K-slot sweep's walk of one ray against ALL g
  slots of its group min(k, K - 1) (the filler ids past n_cand too, as
  the reference sweeps the whole group): any hit ORs into occ; closest
  sweeps [t_min, torch.minimum(t_max, best_t)] by the first-slot rule and
  replaces the carry where that t < best_t.

On a CUDA tensor `cascade_stage` (the packet folds) and `fused_stage` (the
fused folds) launch the stage kernel: the loop of csrc/stage.cuh, one
cooperative launch a stage, the loop, its count and k on the card; a
failed launch raises, there is no fallback. The packet folds are
csrc/ctiles_sweep.cu's, tuned at (T 64, S 128) and (T 256, S 128), every
other S, T >= 1 through their generic instance; they sweep only the blocks
still on the kernel's list, and split each 32-lane slot's group over W
warps, W = split_warps(...) from the stage's size and the instance's
resident warps (W = 1 where the stage fills the card; the same bits at
every W). The fused folds are csrc/fused_anyhit.cu's and
csrc/fused_closest.cu's, only a generic instance (any S, T >= 1), one warp
a slot; they check every candidate id they read against [0, C] and count
the ones outside it in `err`, which the cascade reads once at its end
(`raise_bad_ids`). `perray_stage` (the perray folds) launches the folds of
csrc/kslot_sweep.cu, only a generic instance (any S), one warp a ray; ids
outside [0, C) test nothing.

On a CPU tensor `cascade_stage` runs `cascade_stage_plain`: the same loop
in eager torch, one host read a vote, each iteration's sweep one call of
`sweep` (tile_sweep's plain version); `fused_stage` runs
`fused_stage_plain`: the same loop stepped by traverse._stepped_stage,
each iteration's sweep calls of block_anyhit / block_closest on
`kernel_chunk` blocks at a time (their plain versions on the CPU), and an
id out of range raises at once. `perray_stage`
runs `perray_stage_plain`: the same loop, one host read a vote, each
iteration's sweep one call of `sweep` over the active rays (kslot_sweep's
plain version by default; traverse passes its eager sweeps). On CUDA
tensors `cascade_stage_plain(..., sweep=cuda_ctiles.tile_sweep)`,
`fused_stage_plain` and `perray_stage_plain` are the host-stepped loops
the card ran before the kernel: one sweep launch an iteration (and a
chunk), one host read a vote (and one a sweep set of the closest packet
and fused folds).

Layouts: rays [size, 8, T] (traverse.pack_block_rays or
cuda_ctiles.pack_rays_tiles: row 6 t_max, < 0 dead; row 7 t_min); order_g
[size, K, g] i32; n_cand [size] i32; k [1] i32; tri_pack [C, 10, S]
(cuda_ctiles.pack_tris) for the packet and perray folds, [C+1, 16, S]
(cuda_anyhit.pack_tris_dummy) for the fused folds; err [3] i32
(new_error).
"""

from __future__ import annotations

import ctypes

import torch

from path_tracer_ai_tpu_torch import cuda_build
from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.cuda_ctiles import (
    I32_MAX,
    _check,
    combine_min_tri,
    read_occupancy,
)
from path_tracer_ai_tpu_torch.utils import sync

INF = float("inf")
I32_MIN = -(1 << 31)
SOURCE = "ctiles_sweep"
# The packet folds (by any hit) and the fused folds (by any hit), with the
# source each fused fold is built from.
NAMES = {True: "cascade_stage_any", False: "cascade_stage_first"}
FUSED_NAMES = {True: "fused_stage_any", False: "fused_stage_closest"}
FUSED_SOURCES = {True: "fused_anyhit", False: "fused_closest"}
# The perray folds (by any hit), built from the per-ray K-slot sweep's
# source.
PERRAY_NAMES = {True: "perray_stage_any", False: "perray_stage_first"}
PERRAY_SOURCE = "kslot_sweep"
FOLDS = (*NAMES.values(), *FUSED_NAMES.values(), *PERRAY_NAMES.values())
FUSED_GROUP = 8

# W, the warps the stage kernel gives a slot of 32 lanes (split_warps),
# and the rule's constant.
SPLITS = (1, 2, 4, 8)
SPLIT_K2 = 16

# Kernel launches since the last reset (the plain versions never count),
# those of a generic instance among them, by fold, and by shape: (fold, T,
# S, G, W) -> [launches, blocks], with "generic" as a further element where
# the generic instance ran (the fused folds have only that one, W = 1).
# Updated under sync.lock.
launches = {name: 0 for name in FOLDS}
generic_launches = {name: 0 for name in FOLDS}
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


def _fused_kernel(any_hit: bool):
    fn = getattr(cuda_build.load(FUSED_SOURCES[any_hit]),
                 FUSED_NAMES[any_hit])
    if fn.argtypes is None:
        n_ptr, n_int = (9, 8) if any_hit else (11, 8)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _work(size: int, dev) -> torch.Tensor:
    """The kernel's work buffer (csrc/stage.cuh StageArgs): 14 words of
    grid counts, a vote and an arrival count a block, two lists of `size`
    blocks; zeros (one fill)."""
    return torch.zeros((14 + 4 * size,), dtype=torch.int32, device=dev)


def kernel_occupancy(fold: str, s: int = 0, t_lanes: int = 0) -> dict:
    """Registers per thread and resident warps per SM of a fold's instance:
    a packet fold's (S, T) one (S = 0: the generic one), a fused or perray
    fold's only one (needs the card)."""
    if fold in PERRAY_NAMES.values():
        return read_occupancy(cuda_build.load(PERRAY_SOURCE)
                              .perray_stage_occupancy,
                              int(fold == PERRAY_NAMES[True]))
    if fold in FUSED_NAMES.values():
        lib = cuda_build.load(FUSED_SOURCES[fold == FUSED_NAMES[True]])
        return read_occupancy(getattr(lib, fold + "_occupancy"))
    return read_occupancy(cuda_build.load(SOURCE).cascade_stage_occupancy, s,
                          t_lanes, int(fold == NAMES[True]))


def _check_stage(fold: str, tri_pack, rays, order_g, n_cand, carry, k,
                 entry, pack_rows: int, layout: str) -> tuple:
    """The checks every fold's launch makes (dtypes, devices, shapes);
    returns (size, K, g, S, T, the pack's clusters)."""
    dev = rays.device
    _check("tri_pack", tri_pack, torch.float32, 3, dev)
    _check("rays", rays, torch.float32, 3, dev)
    _check("order_g", order_g, torch.int32, 3, dev)
    _check("n_cand", n_cand, torch.int32, 1, dev)
    _check("k", k, torch.int32, 1, dev)
    c, rows, s = tri_pack.shape
    size, ray_rows, t_lanes = rays.shape
    _n, kgroups, g = order_g.shape
    fused = fold in FUSED_NAMES.values()
    perray = fold in PERRAY_NAMES.values()
    if (rows != pack_rows or ray_rows != cuda_ctiles.RAY_ROWS or _n != size
            or n_cand.shape[0] != size or k.numel() != 1 or kgroups < 1
            or g < 1 or s < 1 or t_lanes < 1
            or (fused and (g != FUSED_GROUP or c < 2))
            or (perray and t_lanes != 1)):
        raise ValueError(
            f"{fold}: shapes tri_pack {tuple(tri_pack.shape)}, rays "
            f"{tuple(rays.shape)}, order_g {tuple(order_g.shape)}, n_cand "
            f"{tuple(n_cand.shape)}, k {tuple(k.shape)} are not {layout}, "
            f"[size,8,{1 if perray else 'T'}], "
            f"[size,K,{FUSED_GROUP if fused else 'g'}], [size], [1]")
    if len(carry) == 1:
        (occ,) = carry
        _check("occ", occ, torch.bool, 2, dev)
    else:
        best_t, best_id = carry
        _check("best_t", best_t, torch.float32, 2, dev)
        _check("best_id", best_id, torch.int32, 2, dev)
    if entry is not None:
        _check("entry", entry, torch.float32, 2, dev)
        if entry.shape[0] != size or entry.shape[1] < (kgroups - 1) * g + 1:
            raise ValueError(f"entry has shape {tuple(entry.shape)}, "
                             f"expected [{size}, >= {(kgroups - 1) * g + 1}]")
    if any(tuple(x.shape) != (size, t_lanes) for x in carry):
        raise ValueError(f"carry shapes {[tuple(x.shape) for x in carry]} "
                         f"are not [{size}, {t_lanes}]")
    return size, kgroups, g, s, t_lanes, c


def _counted(fold: str, key: tuple, size: int, ran_generic: bool) -> None:
    with sync.lock:
        launches[fold] += 1
        generic_launches[fold] += ran_generic
        shape = launch_shapes.setdefault(key, [0, 0])
        shape[0] += 1
        shape[1] += size


def cascade_stage(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                  entry=None):
    """One stage of a packet cascade to its end (see the module): (carry,
    k, act), carry and k updated in place. CUDA tensors launch the stage
    kernel (or raise); CPU tensors run cascade_stage_plain."""
    dev = rays.device
    if dev.type == "cpu":
        return cascade_stage_plain(tri_pack, rays, order_g, n_cand, carry, k,
                                   threshold, entry)
    if dev.type != "cuda":
        raise ValueError(f"cascade_stage runs on cuda or cpu, not {dev}")
    any_hit = entry is None
    name = NAMES[any_hit]
    size, kgroups, g, s, t_lanes, c = _check_stage(
        name, tri_pack, rays, order_g, n_cand, carry, k, entry,
        cuda_ctiles.PACK_ROWS, "[C,10,S]")
    act = torch.empty((size,), dtype=torch.bool, device=dev)
    if size == 0:
        return carry, k, act
    if any_hit:
        ptrs = (0, carry[0].data_ptr(), 0, 0)
        stride = 0
    else:
        ptrs = (entry.data_ptr(), 0, carry[0].data_ptr(),
                carry[1].data_ptr())
        stride = entry.shape[1]
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
    _counted(name, (name, t_lanes, s, g, w)
             + (("generic",) if ran_generic else ()), size, ran_generic)
    return carry, k, act


# ---- the fused folds --------------------------------------------------------

def new_error(dev) -> torch.Tensor:
    """A fused cascade's error words for the stage kernel: ids out of
    range, their least and their largest value."""
    return torch.tensor([0, I32_MAX, I32_MIN], dtype=torch.int32, device=dev)


def raise_bad_ids(err, n_clusters: int) -> None:
    """Raises ValueError if a stage kernel of the cascade read a candidate
    id outside [0, n_clusters]: one host read, at the cascade's end (the
    plain version raises as it meets one, and leaves err as it was)."""
    if err.device.type == "cpu":
        return
    bad, lo, hi = err.tolist()
    sync.note()
    if bad:
        raise ValueError(f"cid8 holds cluster ids in [{lo}, {hi}], outside "
                         f"[0, {n_clusters}] ({bad} reads)")


def _check_ids(cid8, n_clusters: int) -> None:
    """The plain version's range check of the ids it is about to sweep on
    the CPU (block_anyhit / block_closest check their own on the card)."""
    if cid8.device.type != "cpu" or cid8.numel() == 0:
        return
    lo, hi = int(cid8.min()), int(cid8.max())
    if lo < 0 or hi > n_clusters:
        raise ValueError(f"cid8 holds cluster ids in [{lo}, {hi}], outside "
                         f"[0, {n_clusters}]")


def any_rules(tri_pack, max_k: int, early_skip: bool, sub_skip: bool,
              kernel_chunk: int, sweep=None):
    """(active_fn, sweep_update) of the fused any-hit cascade, for blocks
    (rays, n_cand, order_g) and carry (occ,): traverse._stepped_stage's
    arguments. sweep(tri_pack, rays, cid8, early_skip=, sub_skip=) defaults
    to cuda_anyhit.block_anyhit."""
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit

    dummy = tri_pack.shape[0] - 1

    def active_fn(k, blocks, carry):
        # Dead lanes (t_max < 0, ray row 6) can never be occluded and count
        # as resolved, or a mixed block would only retire by exhaustion.
        rays, nc = blocks[:2]
        resolved = carry[0] | (rays[:, 6, :] < 0.0)
        return (k * FUSED_GROUP < nc) & ~resolved.all(dim=1)

    def sweep_update(k, blocks, carry, idx):
        rays, _nc, ordg = blocks
        (occ,) = carry
        cid8 = ordg[idx, min(k, max_k)]                    # [n_act, 8]
        _check_ids(cid8, dummy)
        r_act = rays[idx]
        fn = sweep or cuda_anyhit.block_anyhit
        for lo in range(0, idx.numel(), kernel_chunk):
            hi = lo + kernel_chunk
            hit = fn(tri_pack, r_act[lo:hi], cid8[lo:hi].reshape(-1),
                     early_skip=early_skip, sub_skip=sub_skip)
            occ[idx[lo:hi]] |= hit  # in place: the carry is the stage's
        return (occ,)

    return active_fn, sweep_update


def closest_rules(tri_pack, max_k: int, sub_skip: bool, kernel_chunk: int,
                  sweep=None):
    """(active_fn, sweep_update) of the fused closest cascade, for blocks
    (rays, n_cand, entry, order_g) and carry (best_t, best_id).
    sweep(tri_pack, rays, cid8, sub_skip=) defaults to
    cuda_closest.block_closest. The sweep set is every block with k 8 <
    n_cand (one more host read an iteration), not the active ones."""
    from path_tracer_ai_tpu_torch.accel import cuda_closest

    dummy = tri_pack.shape[0] - 1

    def active_fn(k, blocks, carry):
        # Front-to-back stop at block granularity: once the next group's
        # conservative entry exceeds every live lane's best, no later
        # candidate can improve the block. Dead lanes (t_max < 0, ray row
        # 6) must not gate with their inf.
        rays, nc, ent, _ordg = blocks
        best_eff = torch.where(rays[:, 6, :] < 0.0, -INF, carry[0])
        entry_k = ent[:, min(k, max_k) * FUSED_GROUP]
        return (k * FUSED_GROUP < nc) & (entry_k <= best_eff.amax(dim=1))

    def sweep_update(k, blocks, carry, _idx):
        rays, nc, _ent, ordg = blocks
        best_t, best_id = carry
        # the reference's sweep set: the blocks that the entry rule has
        # retired since the stage began are swept on
        idx = torch.nonzero(k * FUSED_GROUP < nc).squeeze(1)
        sync.note()
        cid8 = ordg[idx, min(k, max_k)]                    # [n, 8]
        _check_ids(cid8, dummy)
        rp = rays[idx]
        # t_max shrinks to the running best; dead lanes stay at -1.
        rp[:, 6, :] = torch.minimum(rp[:, 6, :], best_t[idx])
        fn = sweep or cuda_closest.block_closest
        for lo in range(0, idx.numel(), kernel_chunk):
            hi = lo + kernel_chunk
            sl = idx[lo:hi]
            kt, ktri = fn(tri_pack, rp[lo:hi], cid8[lo:hi].reshape(-1),
                          sub_skip=sub_skip)
            # in place: the carry is the stage's
            best_t[sl], best_id[sl] = combine_min_tri(
                best_t[sl], best_id[sl], kt, ktri)
        return best_t, best_id

    return active_fn, sweep_update


def fused_stage_plain(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                      entry=None, early_skip=False, sub_skip=None,
                      kernel_chunk: int = 8192, err=None, sweep=None,
                      stats=None):
    """The fused folds' stage stepped on the host (see the module): one
    host read of k, one of the active count a vote. sweep: the fold's
    sweep (default block_anyhit / block_closest, which on CUDA tensors
    launch their kernels). stats, if given, gains "active" (the active
    blocks at each vote), "sweeps" (iterations), "blocks" (blocks swept),
    "clusters" ([C + 1] bool, the clusters swept) and, through the plain
    sweeps that it then takes, "tests" and "lane_tests"
    (cuda_anyhit.block_anyhit_plain's and cuda_closest.block_closest_plain's
    counts). err is not read: the plain version raises ValueError at an id
    out of range."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_closest,
        traverse,
    )

    del err
    any_hit = entry is None
    if sub_skip is None:
        sub_skip = not any_hit
    max_k = order_g.shape[1] - 1
    plain = (cuda_anyhit.block_anyhit_plain if any_hit
             else cuda_closest.block_closest_plain)
    if stats is not None:
        def sweep(tri_pack_, rays_, cid8, **kw):
            stats["sweeps"] = stats.get("sweeps", 0) + 1
            stats["blocks"] = stats.get("blocks", 0) + rays_.shape[0]
            mask = stats.setdefault("clusters", torch.zeros(
                tri_pack_.shape[0], dtype=torch.bool, device=cid8.device))
            mask[cid8.long()] = True
            if any_hit:
                return plain(tri_pack_, rays_, cid8, kw["early_skip"],
                             kw["sub_skip"], stats=stats)
            return plain(tri_pack_, rays_, cid8, kw["sub_skip"], stats=stats)
    if any_hit:
        blocks = (rays, n_cand, order_g)
        active_fn, sweep_update = any_rules(tri_pack, max_k, early_skip,
                                            sub_skip, kernel_chunk, sweep)
    else:
        blocks = (rays, n_cand, entry, order_g)
        active_fn, sweep_update = closest_rules(tri_pack, max_k, sub_skip,
                                                kernel_chunk, sweep)
    votes = stats.setdefault("active", []) if stats is not None else None
    cur, kv, act = traverse._stepped_stage(
        blocks, carry, sync.host_int(k), threshold, sweep_update, active_fn,
        votes)
    for dst, src in zip(carry, cur):
        if dst is not src:
            dst.copy_(src)
    k.fill_(kv)
    return carry, k, act


def fused_stage(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                entry=None, early_skip=False, sub_skip=None,
                kernel_chunk: int = 8192, err=None):
    """One stage of a fused cascade to its end (see the module): (carry, k,
    act), carry and k updated in place. CUDA tensors launch the stage
    kernel, one launch whatever kernel_chunk (or raise), and need err
    (new_error), which the caller reads once the cascade is done
    (raise_bad_ids). CPU tensors run fused_stage_plain, which sweeps
    kernel_chunk blocks at a time. sub_skip: default off for any hit, on
    for closest, as any_hit_fused's and closest_hit_fused's defaults."""
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit

    dev = rays.device
    any_hit = entry is None
    if sub_skip is None:
        sub_skip = not any_hit
    if dev.type == "cpu":
        return fused_stage_plain(tri_pack, rays, order_g, n_cand, carry, k,
                                 threshold, entry, early_skip, sub_skip,
                                 kernel_chunk)
    if dev.type != "cuda":
        raise ValueError(f"fused_stage runs on cuda or cpu, not {dev}")
    if err is None:
        raise ValueError("fused_stage on the card needs err (new_error)")
    name = FUSED_NAMES[any_hit]
    size, kgroups, _g, s, t_lanes, c1 = _check_stage(
        name, tri_pack, rays, order_g, n_cand, carry, k, entry,
        cuda_anyhit.PACK_ROWS, "[C+1,16,S]")
    _check("err", err, torch.int32, 1, dev)
    act = torch.empty((size,), dtype=torch.bool, device=dev)
    if size == 0:
        return carry, k, act
    work = _work(size, dev)
    head = (tri_pack.data_ptr(), rays.data_ptr(), order_g.data_ptr(),
            n_cand.data_ptr())
    tail = (k.data_ptr(), act.data_ptr(), work.data_ptr(), err.data_ptr(),
            size, kgroups, s, t_lanes, c1 - 1)
    if any_hit:
        args = (*head, carry[0].data_ptr(), *tail, int(threshold),
                int(early_skip), int(sub_skip))
    else:
        args = (*head, entry.data_ptr(), carry[0].data_ptr(),
                carry[1].data_ptr(), *tail, entry.shape[1], int(threshold),
                int(sub_skip))
    code = cuda_build.launch(_fused_kernel(any_hit), dev, *args)
    if code != 0:
        raise RuntimeError(f"fused_stage launch failed: cudaError {code}")
    _counted(name, (name, t_lanes, s, FUSED_GROUP, 1, "generic"), size,
             True)
    return carry, k, act


# ---- the perray folds -------------------------------------------------------

def perray_stage_plain(tri_pack, rays, order_g, n_cand, carry, k, threshold,
                       sweep=None, stats=None):
    """The perray folds' stage stepped on the host (see the module): one
    host read of k, one of the active count a vote; each iteration's sweep
    is one call sweep(tri_pack, rays [n, 8], cid [n, g]) over the active
    rays, every slot of their group min(k, K - 1) (row 6 of a closest
    sweep's rays is min(t_max, best t)), returning (t [n], tri [n]) of the
    first slot at the least t, or (occluded [n],) for any hit. sweep
    defaults to cuda_kslots.kslot_sweep (tie="slot" for closest), whose
    plain version runs on CPU tensors and whose kernel on CUDA tensors, one
    launch an iteration: the loop the card ran before the stage kernel.
    stats, if given, gains "active" (the active rays at each vote),
    "sweeps" (iterations), "rays" (rays swept) and "clusters" ([C] bool,
    the clusters swept)."""
    from path_tracer_ai_tpu_torch.accel import cuda_kslots

    any_hit = len(carry) == 1
    _size, kgroups, g = order_g.shape
    rows = rays[:, :, 0]  # [size, 8]: o, d, t_max, t_min
    if sweep is None:
        def sweep(pack, r, cid):
            # every slot: the reference sweeps the whole group, the filler
            # ids past n_cand too
            n_slots = torch.full((r.shape[0],), g, dtype=torch.int32,
                                 device=r.device)
            return cuda_kslots.kslot_sweep(
                pack, r, cid, n_slots, not any_hit,
                **({} if any_hit else {"tie": "slot"}))
    kv = sync.host_int(k)
    while True:
        if any_hit:
            act = (kv * g < n_cand) & ~carry[0][:, 0]
        else:
            act = (kv * g < n_cand) & (rows[:, 6] >= 0.0)
        idx = torch.nonzero(act).squeeze(1)
        sync.note()
        if stats is not None:
            stats.setdefault("active", []).append(idx.numel())
        if idx.numel() <= threshold:
            break
        cid = order_g[idx, min(kv, kgroups - 1)]
        r = rows[idx]
        if stats is not None:
            stats["sweeps"] = stats.get("sweeps", 0) + 1
            stats["rays"] = stats.get("rays", 0) + idx.numel()
            mask = stats.setdefault("clusters", torch.zeros(
                tri_pack.shape[0], dtype=torch.bool, device=cid.device))
            ids = cid.reshape(-1).long()
            mask[ids[(ids >= 0) & (ids < tri_pack.shape[0])]] = True
        if any_hit:
            (hit,) = sweep(tri_pack, r, cid)
            carry[0][idx, 0] |= hit
        else:
            best_t, best_id = carry
            bt = best_t[idx, 0]
            r[:, 6] = torch.minimum(r[:, 6], bt)
            ct, gid = sweep(tri_pack, r, cid)
            closer = ct < bt
            best_t[idx, 0] = torch.where(closer, ct, bt)
            best_id[idx, 0] = torch.where(closer, gid, best_id[idx, 0])
        kv += 1
    k.fill_(kv)
    return carry, k, act


def _perray_kernel():
    fn = cuda_build.load(PERRAY_SOURCE).perray_stage
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def perray_stage(tri_pack, rays, order_g, n_cand, carry, k, threshold):
    """One stage of a perray query to its end (see the module): (carry, k,
    act), carry and k updated in place; carry (occ,) is the any-hit fold,
    (best_t, best_id) the first-slot closest one. CUDA tensors launch the
    stage kernel (or raise); CPU tensors run perray_stage_plain."""
    dev = rays.device
    if dev.type == "cpu":
        return perray_stage_plain(tri_pack, rays, order_g, n_cand, carry, k,
                                  threshold)
    if dev.type != "cuda":
        raise ValueError(f"perray_stage runs on cuda or cpu, not {dev}")
    any_hit = len(carry) == 1
    name = PERRAY_NAMES[any_hit]
    size, kgroups, g, s, _t, c = _check_stage(
        name, tri_pack, rays, order_g, n_cand, carry, k, None,
        cuda_ctiles.PACK_ROWS, "[C,10,S]")
    act = torch.empty((size,), dtype=torch.bool, device=dev)
    if size == 0:
        return carry, k, act
    ptrs = ((carry[0].data_ptr(), 0, 0) if any_hit
            else (0, carry[0].data_ptr(), carry[1].data_ptr()))
    work = _work(size, dev)
    args = (tri_pack.data_ptr(), rays.data_ptr(), order_g.data_ptr(),
            n_cand.data_ptr(), *ptrs, k.data_ptr(), act.data_ptr(),
            work.data_ptr(), size, kgroups, g, s, c, int(threshold),
            int(any_hit))
    err = cuda_build.launch(_perray_kernel(), dev, *args)
    if err != 0:
        raise RuntimeError(f"perray_stage launch failed: cudaError {err}")
    _counted(name, (name, 1, s, g, 1, "generic"), size, True)
    return carry, k, act
