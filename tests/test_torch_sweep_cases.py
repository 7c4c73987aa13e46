"""Crafted inputs for the port's two sweeps of its own, `item_sweep` (the
worklist's item sweep) and `kslot_sweep` (the kslots backend's), and for
the first-slot instances of `tile_sweep` and `kslot_sweep` (the packet
cascade's and the perray query's sweep, tie="slot"), as numpy arrays. numpy only, so that tests/test_torch_cuda.py (on the GPU machine,
which has no JAX) and tests/test_torch_sweep_edges.py (on the CPU, against
the JAX package) see the same inputs. This file holds no test.

The geometry: C = 6 clusters of S triangles, cluster c a grid of small
right triangles over the unit square near the plane z = Z[c], rays from
z = -2 nearly along +z. Cluster 1 is cluster 0 copied (the same floats,
so the same t bit for bit) with smaller triangle ids: where both are
swept, the closest hit is an exact t tie that the smaller id must win,
also when its cluster comes in a later slot. Cluster C - 1 lies nearest to
the rays, and slots past n_cand / n_slots point at it (as the culls'
garbage entries do): a sweep that failed to mask them would return its
triangles.

The first-slot cases (FIRST_CASES) turn that tie round: the packet
cascade keeps the FIRST slot at the minimum t, so where cluster 0 comes
before its copy, cluster 1, cluster 0's larger ids must win. Their
cluster 2 holds each of its even slots' triangles again in the next slot
with the smaller id of the two (first_clusters), so the two rules part
within one cluster too.

The cascade cases (CASCADE_CASES, cascade_case) are whole packet
cascades: ray blocks with their candidate tables, for the cascade stage
(accel.cuda_cascade) run through traverse._cascade_stages, any hit and
first-slot closest (see cascade_case for each case). The split cases
(SPLIT_CASES, split_case) are cascades of the same layout whose exact ties
straddle the boundaries where the stage kernel cuts a slot's group into W
ranges, one a warp. The perray cases (PERRAY_CASES, perray_case) are whole
perray cascades: one-ray blocks with their candidate rows, for the perray
stage (see perray_case). The slot cases (SLOT_CASES, slot_case) are
ctiles' static slot tables over exact geometry (exact_clusters), for
cuda_ctiles.slot_sweep and its plain version: exact t ties across the
clusters of one row, a hit at exactly t_min, -0.0 against +0.0, a row's
pairs spread over several tiles, padding slots and dead rows, and a live
tile count of 0. The cull cases (CULL_CASES, cull_case) are ray blocks
and cluster boxes for the packet cascades' interval cull
(traverse._block_candidates: accel.cuda_cull's kernel and plain version):
all-dead and mixed blocks, +0.0 / -0.0 direction components, entries
tied at 0 and tied above it, flat boxes, blocks where every cluster is a
candidate, t_max = +inf lanes and candidates whose entry is +inf.
"""

import numpy as np

SIZES = (2, 16, 96, 128, 512)
N_CLUSTERS = 6
Z = (2.0, 2.0, 6.0, 3.0, 5.0, 1.0)  # cluster planes; C - 1 nearest
T_MIN = 1e-3
B, G = 8, 4  # rays a block, clusters an item
K = 6  # slots a kslots row

ITEM_CASES = ("ties", "repeats", "garbage_slots", "dead_rays",
              "occluded_first_chunk", "no_items", "full_table")
KSLOT_CASES = ("ties", "repeats", "garbage_slots", "dead_rays",
               "overflowed", "occluded_first_chunk")
FIRST_CASES = ("ties_across_clusters", "ties_within_cluster", "dead_lanes",
               "misses", "repeats")
FIRST_T = (1, 64, 256)  # lanes a tile of the first-slot tile_sweep cases
FIRST_G = (1, 4, 8)     # clusters a tile (slots a kslots row)


def clusters(s: int, rng) -> dict:
    """v0, e1, e2 [C, S, 3] f32 and tri_id [C, S] i32 (see the module)."""
    w = int(np.ceil(np.sqrt(s)))
    j = np.arange(s)
    cell = 1.0 / w
    v0 = np.zeros((N_CLUSTERS, s, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    for c in range(N_CLUSTERS):
        src = 0 if c == 1 else c  # cluster 1 is cluster 0's copy
        r = np.random.default_rng([src, s, int(rng.integers(1 << 30))]
                                  if src != 0 else [0, s])
        v0[c, :, 0] = (j % w) * cell
        v0[c, :, 1] = (j // w) * cell
        v0[c, :, 2] = Z[c] + r.uniform(-0.05, 0.05, s)
        e1[c, :, 0] = 0.9 * cell
        e1[c, :, 2] = r.uniform(-0.05, 0.05, s)
        e2[c, :, 1] = 0.9 * cell
        e2[c, :, 2] = r.uniform(-0.05, 0.05, s)
    base = np.array([5, 0, 2, 3, 4, 6]) * s + 100  # cluster 1's ids smallest
    tri_id = (base[:, None] + j[None, :]).astype(np.int32)
    return {"v0": v0, "e1": e1, "e2": e2, "tri_id": tri_id}


def pack(geo: dict) -> np.ndarray:
    """[C, 10, S] f32 (cuda_ctiles.pack_tris' layout)."""
    rows = [geo[k][:, :, a] for k in ("v0", "e1", "e2") for a in range(3)]
    rows.append(geo["tri_id"].view(np.float32))
    return np.ascontiguousarray(np.stack(rows, axis=1))


def _rays(rng, n: int, s: int, first_chunk: bool = False):
    """n rays from z = -2 through random points of the unit square (or,
    with first_chunk, through the middle of the first min(S, 32) triangles'
    right angles), tilted a little; t_max in [3.5, 12] (a few stop before
    the far planes)."""
    w = int(np.ceil(np.sqrt(s)))
    if first_chunk:
        j = rng.integers(0, min(s, 32), n)
        xy = np.stack([(j % w) + 0.2, (j // w) + 0.2], 1) / w
        tilt = rng.uniform(-1e-4, 1e-4, (n, 2))
    else:
        xy = rng.uniform(0.0, 1.0, (n, 2))
        tilt = rng.uniform(-0.02, 0.02, (n, 2))
    o = np.concatenate([xy, np.full((n, 1), -2.0)], 1).astype(np.float32)
    d = np.concatenate([tilt, np.ones((n, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(3.5, 12.0, n).astype(np.float32)
    return o, d, tm


def item_case(name: str, s: int, seed: int = 0) -> dict:
    """One crafted worklist input: the clusters, block rays o_blk / d_blk
    [nb, B, 3] and tm_blk [nb, B] (t_max; dead rays -1), t_min, and the
    WorkList tables item_block [i_cap], ibase, n_cand [nb], order_g [nb,
    n_groups, G] and n_items. Slots past a block's n_cand hold C - 1."""
    rng = np.random.default_rng([seed, s, ITEM_CASES.index(name)])
    geo = clusters(s, rng)
    last = N_CLUSTERS - 1
    orders = {  # a block's candidate clusters (n_cand of them)
        "ties": [[0, 1, 2, 3], [1, 0, 3, 2, 0, 1], [2, 1, 0]],
        "repeats": [[3, 3, 0, 3], [2, 2, 2, 2, 1, 1], [0, 0]],
        "garbage_slots": [[0], [3, 1], [2, 4, 0], [1, 2, 3, 4, 0]],
        "dead_rays": [[0, 1, 2, 3], [3, 4], [0, 2, 4, 1, 3]],
        "occluded_first_chunk": [[0, last, 2, 3], [1, 3, 4, 2]],
        "no_items": [[0, 1, 2, 3], [4, 3]],
        "full_table": [[0, 1, 2, 3, 4, 5, 1, 0]] * 4,
    }[name]
    nb = len(orders)
    o, d, tm = _rays(rng, nb * B, s,
                     first_chunk=name == "occluded_first_chunk")
    if name == "ties":
        tm[:] = np.inf
    if name == "occluded_first_chunk":
        tm[:] = 10.0  # past every plane
    if name == "dead_rays":
        tm[::3] = -1.0
        tm[B:2 * B] = -1.0  # block 1: every ray dead
    n_cand = np.array([len(x) for x in orders], np.int32)
    m = -(-n_cand // G)
    n_groups = int(m.max())
    order_g = np.full((nb, n_groups * G), last, np.int32)
    for b, x in enumerate(orders):
        order_g[b, :len(x)] = x
    ibase = (np.cumsum(m) - m).astype(np.int32)
    n_items = int(m.sum())
    i_cap = n_items if name == "full_table" else -(-(n_items + 3) // 8) * 8
    item_block = np.full(i_cap, nb - 1, np.int32)
    for b in range(nb):
        item_block[ibase[b]:ibase[b] + m[b]] = b
    return {**geo, "o_blk": o.reshape(nb, B, 3), "d_blk": d.reshape(nb, B, 3),
            "tm_blk": tm.reshape(nb, B), "t_min": T_MIN,
            "item_block": item_block, "ibase": ibase, "n_cand": n_cand,
            "order_g": order_g.reshape(nb, n_groups, G),
            "n_items": 0 if name == "no_items" else n_items}


def item_block_rays(case: dict) -> np.ndarray:
    """[nb, 8, B] f32 (traverse.pack_block_rays' layout: ox oy oz dx dy dz
    t_max t_min)."""
    tmin = np.full_like(case["tm_blk"], case["t_min"])
    return np.ascontiguousarray(np.concatenate(
        [case["o_blk"].transpose(0, 2, 1), case["d_blk"].transpose(0, 2, 1),
         case["tm_blk"][:, None], tmin[:, None]], axis=1), np.float32)


def kslot_case(name: str, s: int, seed: int = 0) -> dict:
    """One crafted kslots input: the clusters, rays o, d [N, 3], t_max [N]
    (dead and overflowed rays -1, as the kslots query passes them), t_min,
    cid [N, K] and n_slots [N]. Slots past n_slots hold C - 1."""
    rng = np.random.default_rng([seed, s, 100 + KSLOT_CASES.index(name)])
    geo = clusters(s, rng)
    last = N_CLUSTERS - 1
    n = 64
    o, d, tm = _rays(rng, n, s, first_chunk=name == "occluded_first_chunk")
    rows = {
        "ties": [[0, 1, 2, 3], [1, 0], [2, 3, 1, 0, 4], [0, 1]],
        "repeats": [[3, 3, 0, 3, 3, 3], [2, 2], [0, 0, 0, 0]],
        "garbage_slots": [[], [0], [3, 1], [2, 4, 0], [1, 2, 3, 4, 0]],
        "dead_rays": [[0, 1, 2, 3], [3, 4], [0, 2, 4, 1, 3]],
        "overflowed": [[0, 1, 2], [], [3, 4, 0, 1]],
        "occluded_first_chunk": [[0, last, 2, 3], [0, 3, 4, 2, 1]],
    }[name]
    cid = np.full((n, K), last, np.int32)
    n_slots = np.zeros(n, np.int32)
    for r in range(n):
        x = rows[r % len(rows)]
        cid[r, :len(x)] = x
        n_slots[r] = len(x)
    if name == "ties":
        tm[:] = np.inf
    if name == "occluded_first_chunk":
        tm[:] = 10.0  # past every plane
    if name == "dead_rays":
        tm[::3] = -1.0
    if name == "overflowed":  # the cull's overflow rows: no slot, t_max -1
        over = np.arange(n) % 3 == 1
        tm[over] = -1.0
    return {**geo, "o": o, "d": d, "tm": tm, "t_min": T_MIN, "cid": cid,
            "n_slots": n_slots}


def kslot_rays(case: dict) -> np.ndarray:
    """[N, 8] f32 (cuda_kslots.pack_rays' layout: o, d, t_max, t_min)."""
    n = case["o"].shape[0]
    return np.ascontiguousarray(np.concatenate(
        [case["o"], case["d"], case["tm"][:, None],
         np.full((n, 1), case["t_min"])], axis=1), np.float32)


def first_clusters(s: int, rng) -> dict:
    """clusters(), with cluster 2's odd slot 2k + 1 a copy of slot 2k's
    triangle (the same floats) and the two ids swapped, so that the later
    slot holds the smaller id (S = 1: unchanged)."""
    geo = clusters(s, rng)
    for k in ("v0", "e1", "e2"):
        geo[k][2, 1::2] = geo[k][2, 0:s - 1:2]
    ids = geo["tri_id"][2].copy()
    geo["tri_id"][2, 0:s - 1:2] = ids[1::2]
    geo["tri_id"][2, 1::2] = ids[0:s - 1:2]
    return geo


def _first_rows(name: str, g: int) -> list:
    """The clusters of a first-slot case's tiles (rows), g a row, cycled."""
    rows = {
        # cluster 0 before its copy 1 (and after it): the first wins
        "ties_across_clusters": [[0, 1, 3, 2], [3, 0, 1, 4], [1, 0, 2, 3]],
        # cluster 2 alone (each hit ties in two slots of it)
        "ties_within_cluster": [[2, 2, 2, 2]],
        "dead_lanes": [[0, 1, 2, 3], [4, 3, 1, 0]],
        "misses": [[0, 1, 2, 3], [3, 4, 2, 0]],
        # a cluster named twice in a row: the same triangle in two slots
        "repeats": [[3, 3, 0, 3], [1, 2, 1, 0]],
    }[name]
    return [[row[i % len(row)] for i in range(g)] for row in rows]


def first_case(name: str, s: int, t_lanes: int, g: int, seed: int = 0,
               nt: int = 0) -> dict:
    """One crafted first-slot tile_sweep input: the clusters
    (first_clusters), rays [nt, 8, T] (traverse.pack_block_rays' layout;
    nt 0: 12 tiles, 96 below 32 lanes)
    and tile_cid [nt, G] i32. dead_lanes: every third lane and, at T >= 64,
    lanes 32-63 of every other tile dead (t_max -1), every fifth tile all
    dead; misses: t_max 0.5 (short of every plane) in every other tile;
    ties: t_max inf."""
    nt = nt or (12 if t_lanes >= 32 else 96)
    rng = np.random.default_rng([seed, s, t_lanes, g,
                                 200 + FIRST_CASES.index(name)])
    geo = first_clusters(s, rng)
    o, d, tm = _rays(rng, nt * t_lanes, s)
    tm = tm.reshape(nt, t_lanes)
    if name.startswith("ties"):
        tm[:] = np.inf
    if name == "dead_lanes":
        tm.reshape(-1)[::3] = -1.0
        if t_lanes >= 64:
            tm[::2, 32:64] = -1.0
        tm[::5] = -1.0
    if name == "misses":
        tm[::2] = 0.5
    rows = _first_rows(name, g)
    cid = np.asarray([rows[i % len(rows)] for i in range(nt)], np.int32)
    tmin = np.full_like(tm, T_MIN)
    rays = np.concatenate(
        [o.reshape(nt, t_lanes, 3).transpose(0, 2, 1),
         d.reshape(nt, t_lanes, 3).transpose(0, 2, 1), tm[:, None],
         tmin[:, None]], axis=1)
    return {**geo, "rays": np.ascontiguousarray(rays, np.float32),
            "tile_cid": cid, "t_min": T_MIN}


def first_kslot_case(name: str, s: int, k: int, seed: int = 0,
                     n: int = 96) -> dict:
    """One crafted first-slot kslot_sweep input (the perray sweep: every
    ray's k slots live): the clusters (first_clusters), ray rows [N, 8]
    (cuda_kslots.pack_rays' layout), cid [N, K] i32 and n_slots [N] = K.
    Rays as first_case's, by ray in place of by tile."""
    rng = np.random.default_rng([seed, s, k, 300 + FIRST_CASES.index(name)])
    geo = first_clusters(s, rng)
    o, d, tm = _rays(rng, n, s)
    if name.startswith("ties"):
        tm[:] = np.inf
    if name == "dead_lanes":
        tm[::3] = -1.0
    if name == "misses":
        tm[::2] = 0.5
    rows = _first_rows(name, k)
    cid = np.asarray([rows[i % len(rows)] for i in range(n)], np.int32)
    rays = np.concatenate([o, d, tm[:, None], np.full((n, 1), T_MIN)], 1)
    return {**geo, "rays": np.ascontiguousarray(rays, np.float32),
            "cid": cid, "n_slots": np.full(n, k, np.int32), "t_min": T_MIN}


# --- the cascade cases: whole packet cascades -------------------------------

CASCADE_CASES = ("half_active", "small_nb", "no_candidates", "all_dead",
                 "carried_k", "retired_face", "signed_zero")
CASCADE_T = (1, 64, 256)  # lanes a block
CASCADE_G = (1, 2, 5, 8)  # clusters a group (5 and 8: C not a multiple)
CASCADE_C = 12
CASCADE_BLOCKS = {"half_active": 128, "small_nb": 40, "carried_k": 256}


def cascade_clusters(s: int) -> dict:
    """CASCADE_C clusters of S triangles over the unit square (clusters()'
    grid). Clusters 1-9: near the plane z = 1 + 0.5 c, tilted and jittered
    a little. Cluster 0: flat at z = 1 (a plane on its box face); cluster
    10: cluster 0's triangles wound the other way (e1 and e2 swapped), so
    a ray from that plane meets them at t = +0.0 where cluster 0 gives
    -0.0; cluster 11: cluster 0 moved to z = 0.999, 1e-3 nearer the rays
    from z = -2. Ids: cluster c's triangle j is 100 + c S + j."""
    w = int(np.ceil(np.sqrt(s)))
    j = np.arange(s)
    cell = 1.0 / w
    c_n = CASCADE_C
    v0 = np.zeros((c_n, s, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    v0[:, :, 0] = (j % w) * cell
    v0[:, :, 1] = (j // w) * cell
    e1[:, :, 0] = 0.9 * cell
    e2[:, :, 1] = 0.9 * cell
    for c in range(1, 10):
        r = np.random.default_rng([c, s, 77])
        v0[c, :, 2] = 1.0 + 0.5 * c + r.uniform(-0.05, 0.05, s)
        e1[c, :, 2] = r.uniform(-0.05, 0.05, s)
        e2[c, :, 2] = r.uniform(-0.05, 0.05, s)
    v0[0, :, 2] = v0[10, :, 2] = 1.0
    v0[11, :, 2] = 0.999
    e1[10], e2[10] = e2[0].copy(), e1[0].copy()
    tri_id = (100 + np.arange(c_n)[:, None] * s + j[None, :]).astype(np.int32)
    return {"v0": v0, "e1": e1, "e2": e2, "tri_id": tri_id}


def _cascade_z(c: int) -> float:
    return 0.999 if c == 11 else 1.0 if c in (0, 10) else 1.0 + 0.5 * c


def _aimed_rays(rng, n: int, s: int, z0: float):
    """n rays from z = z0 through the interiors of random triangles of the
    grid (0.2 cell past their right angles), nearly along +z."""
    w = int(np.ceil(np.sqrt(s)))
    j = rng.integers(0, s, n)
    xy = np.stack([(j % w) + 0.2, (j // w) + 0.2], 1) / w
    o = np.concatenate([xy, np.full((n, 1), z0)], 1).astype(np.float32)
    d = np.concatenate([rng.uniform(-1e-4, 1e-4, (n, 2)), np.ones((n, 1))],
                       1)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def cascade_case(name: str, s: int, t_lanes: int, g: int,
                 seed: int = 0) -> dict:
    """One crafted packet cascade: the clusters (cascade_clusters), block
    rays o, d [nb, T, 3], tm [nb, T] (t_max; dead -1), t_min, rays [nb, 8,
    T] (traverse.pack_block_rays' layout) and the candidate table as the
    cascades build it: order_g [nb, K, g] i32 (K = ceil(C / g), padded
    with cluster 0), n_cand [nb] i32, entry [nb, K g] f32 (padded with inf).
    A block's candidates come front to back with a conservative entry
    (z + 1.94), then the other clusters in id order (entry inf). Cases:

    half_active: 128 blocks, every lane live and short of every plane
      (t_max 0.5), half the blocks with one group of candidates, half with
      all C: the first stage ends with exactly size // 2 blocks active.
    small_nb: 40 blocks (fewer than 64: one stage, the last).
    no_candidates: every third block has n_cand 0.
    all_dead: every lane dead.
    carried_k: 256 blocks (four stages, k carried from each to the next),
      every third lane and every fifth block dead.
    retired_face: a third of the blocks aim every lane at cluster 0 (flat,
      a plane on its box face) and hold cluster 11 (cluster 0 1e-3 nearer)
      in their second group with an entry past every hit: the entry rule
      retires them after their first group, but the closest fold's sweep
      set keeps them while the stage runs on, and cluster 11 then holds a
      nearer hit; the others hold all C with rays that mostly miss.
    signed_zero: t_min 0, rays from the plane z = 1 through cluster 0's
      triangles, cluster 0 and cluster 10 (t -0.0 and +0.0) first in either
      order, entries -0.0 then +0.0: exact ties of signed zeros."""
    rng = np.random.default_rng([seed, s, t_lanes, g,
                                 400 + CASCADE_CASES.index(name)])
    c_n = CASCADE_C
    nb = CASCADE_BLOCKS.get(name, 96)
    n = nb * t_lanes
    geo = cascade_clusters(s)
    o, d, tm = _rays(rng, n, s)
    t_min = 0.0 if name == "signed_zero" else T_MIN
    z = np.asarray([_cascade_z(c) for c in range(c_n)], np.float32)
    far = list(range(1, 10))
    orders, ncs, entries = [], [], []
    kind = np.zeros(nb, np.int32)  # 1: retired_face's aimed blocks
    if name == "retired_face":
        kind[::3] = 1
        for b in np.flatnonzero(kind):
            sl = slice(b * t_lanes, (b + 1) * t_lanes)
            o[sl], d[sl] = _aimed_rays(rng, t_lanes, s, -2.0)
            tm[sl] = np.inf
    if name == "signed_zero":
        o, d = _aimed_rays(rng, n, s, 1.0)
    for b in range(nb):
        if name == "half_active":
            cand = sorted(rng.permutation(c_n)[:g if b % 2 else c_n],
                          key=lambda c: z[c])
        elif name == "retired_face" and kind[b]:
            first = [0] + sorted(rng.choice(far, g - 1, replace=False),
                                 key=lambda c: z[c])
            rest = [c for c in range(c_n) if c not in first and c != 11]
            cand = first + [11] + sorted(rest, key=lambda c: z[c])
        elif name == "signed_zero":
            pair = [0, 10] if b % 2 else [10, 0]
            cand = pair + sorted(rng.choice(far, int(rng.integers(0, 4)),
                                            replace=False),
                                 key=lambda c: z[c])
        elif name == "retired_face":
            cand = sorted(range(c_n), key=lambda c: z[c])
        else:
            k_n = int(rng.integers(0, c_n + 1))
            cand = sorted(rng.choice(c_n, k_n, replace=False),
                          key=lambda c: z[c])
            if name == "no_candidates" and b % 3 == 0:
                cand = []
        cand = [int(c) for c in cand]
        ent = [float(z[c]) + 1.94 for c in cand]
        if name == "retired_face" and kind[b]:
            ent[g:] = [max(ent[:g] + [3.3]) + 0.05 * (i + 1)
                       for i in range(len(ent) - g)]
        if name == "signed_zero":
            ent[:2] = [-0.0, 0.0]
        rest = [c for c in range(c_n) if c not in cand]
        orders.append(cand + rest)
        ncs.append(len(cand))
        entries.append(ent + [np.inf] * len(rest))
    tm = tm.reshape(nb, t_lanes)
    if name == "half_active":
        tm[:] = 0.5
    if name == "all_dead":
        tm[:] = -1.0
    if name == "carried_k":
        tm.reshape(-1)[::3] = -1.0
        tm[::5] = -1.0
    if name == "signed_zero":
        tm[:] = np.inf
    k_groups = -(-c_n // g)
    pad = k_groups * g - c_n
    order = np.pad(np.asarray(orders, np.int32), ((0, 0), (0, pad)))
    entry = np.pad(np.asarray(entries, np.float32), ((0, 0), (0, pad)),
                   constant_values=np.inf)
    o = o.reshape(nb, t_lanes, 3)
    d = d.reshape(nb, t_lanes, 3)
    rays = np.concatenate([o.transpose(0, 2, 1), d.transpose(0, 2, 1),
                           tm[:, None], np.full_like(tm, t_min)[:, None]], 1)
    return {**geo, "o": o, "d": d, "tm": tm, "t_min": t_min,
            "rays": np.ascontiguousarray(rays, np.float32),
            "order_g": np.ascontiguousarray(order.reshape(nb, k_groups, g)),
            "n_cand": np.asarray(ncs, np.int32),
            "entry": np.ascontiguousarray(entry), "kind": kind}


# --- the split cases: ties across the stage kernel's W ranges --------------

SPLIT_CASES = ("straddle_ties", "signed_zero", "nan_and_dead")
SPLIT_C = 4
# the blocks' candidate orders, by block: -0.0 before +0.0 and after it
SPLIT_ORDERS = ([0, 1, 2, 3], [1, 0, 3, 2], [2, 3, 1, 0], [3, 2, 0, 1],
                [1, 3, 0, 2], [0, 2, 1, 3])


def split_clusters(s: int) -> dict:
    """SPLIT_C clusters of S triangles over the unit square (cascade_clusters'
    grid). Cluster 0: flat at z = 1; cluster 1: cluster 0 wound the other
    way (a ray from that plane meets it at t = +0.0 where cluster 0 gives
    -0.0); cluster 2: cluster 0 again, each slot j of its second half the
    same floats as slot j - S // 2 (so an exact tie in two slots a
    half-cluster apart, across a chunk boundary from S = 64 on) with the
    smaller id of the two; cluster 3: cluster 0 again (a tie across
    clusters) with smaller ids. Ids: 1000 + c S + j, the copies' below."""
    base = cascade_clusters(s)
    geo = {k: np.stack([base[k][0]] * SPLIT_C) for k in ("v0", "e1", "e2")}
    geo["e1"][1], geo["e2"][1] = base["e2"][0].copy(), base["e1"][0].copy()
    h = s // 2
    if h:
        for k in ("v0", "e1", "e2"):
            geo[k][2, h:2 * h] = geo[k][2, :h]
    j = np.arange(s)
    tri_id = (1000 + np.arange(SPLIT_C)[:, None] * s + j[None, :])
    tri_id[2, h:2 * h] = 1000 - 1 - j[:h]
    tri_id[3] = 100 + j
    return {**geo, "tri_id": tri_id.astype(np.int32)}


def split_case(name: str, s: int, t_lanes: int, g: int,
               seed: int = 0) -> dict:
    """One crafted cascade on split_clusters, cascade_case's layout (96
    blocks; candidates: every cluster, in one of SPLIT_ORDERS by block,
    each with entry 2.94; K = ceil(C / g) groups padded with cluster
    0, entry inf). straddle_ties: rays from z = -2 through the first half
    of the triangles (t_max inf): every hit is an exact tie in two slots of
    cluster 2 and across clusters 0, 2 and 3. signed_zero: t_min 0, rays
    from the plane z = 1 through the same triangles: t = -0.0 in clusters
    0, 2, 3, +0.0 in cluster 1. nan_and_dead: straddle_ties with t_max NaN
    in every third lane, -1 in every fifth, lanes 32-63 dead in every
    other block and every seventh block dead."""
    rng = np.random.default_rng([seed, s, t_lanes, g,
                                 500 + SPLIT_CASES.index(name)])
    nb = 96
    n = nb * t_lanes
    geo = split_clusters(s)
    w = int(np.ceil(np.sqrt(s)))
    jj = rng.integers(0, max(s // 2, 1), n)
    xy = np.stack([(jj % w) + 0.2, (jj // w) + 0.2], 1) / w
    z0 = 1.0 if name == "signed_zero" else -2.0
    o = np.concatenate([xy, np.full((n, 1), z0)], 1).astype(np.float32)
    d = np.concatenate([rng.uniform(-1e-4, 1e-4, (n, 2)), np.ones((n, 1))],
                       1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = np.full((nb, t_lanes), np.inf, np.float32)
    if name == "nan_and_dead":
        tm.reshape(-1)[::3] = np.nan
        tm.reshape(-1)[::5] = -1.0
        if t_lanes >= 64:
            tm[::2, 32:64] = -1.0
        tm[::7] = -1.0
    t_min = 0.0 if name == "signed_zero" else T_MIN
    orders = [SPLIT_ORDERS[b % len(SPLIT_ORDERS)] for b in range(nb)]
    k_groups = -(-SPLIT_C // g)
    pad = k_groups * g - SPLIT_C
    order = np.pad(np.asarray(orders, np.int32), ((0, 0), (0, pad)))
    entry = np.pad(np.full((nb, SPLIT_C), 2.94, np.float32),
                   ((0, 0), (0, pad)), constant_values=np.inf)
    o = o.reshape(nb, t_lanes, 3)
    d = d.reshape(nb, t_lanes, 3)
    rays = np.concatenate([o.transpose(0, 2, 1), d.transpose(0, 2, 1),
                           tm[:, None], np.full_like(tm, t_min)[:, None]], 1)
    return {**geo, "o": o, "d": d, "tm": tm, "t_min": t_min,
            "rays": np.ascontiguousarray(rays, np.float32),
            "order_g": np.ascontiguousarray(order.reshape(nb, k_groups, g)),
            "n_cand": np.full(nb, SPLIT_C, np.int32),
            "entry": np.ascontiguousarray(entry)}


# --- the fused cascade cases: the fused cascades' stage ---------------------

FUSED_CASES = ("half_active", "small_nb", "no_candidates", "all_dead",
               "carried_k", "retired_face", "later_tie", "retired_tie",
               "signed_zero_tie")
FUSED_T = (64, 128)  # lanes a block
FUSED_G = 8          # clusters a group: the fused kernels' GROUP
FUSED_C = CASCADE_C + 1


def fused_clusters(s: int) -> dict:
    """cascade_clusters' CASCADE_C clusters and cluster 12, cluster 0 again
    with smaller ids (j where cluster 0 has 100 + j): an exact t tie that
    the smaller id wins, in a later group. Also the clusters' boxes bmin,
    bmax [C, 3] (of the vertices v0, v0 + e1, v0 + e2)."""
    geo = cascade_clusters(s)
    for k in ("v0", "e1", "e2"):
        geo[k] = np.concatenate([geo[k], geo[k][:1]])
    geo["tri_id"] = np.concatenate(
        [geo["tri_id"], np.arange(s, dtype=np.int32)[None]])
    verts = np.concatenate([geo["v0"], geo["v0"] + geo["e1"],
                            geo["v0"] + geo["e2"]], axis=1)
    geo["bmin"] = verts.min(axis=1).astype(np.float32)
    geo["bmax"] = verts.max(axis=1).astype(np.float32)
    return geo


def _tie_case(name: str, s: int, t_lanes: int, rng) -> dict:
    """40 blocks (one stage, the last) aimed through cluster 0's triangles
    (t_max inf). later_tie: every block sweeps [0, seven far clusters] and
    then [12] (cluster 0 with smaller ids, entry 2.94, under every hit):
    the lexicographic fold must take the smaller id at an equal t from a
    later group. retired_tie: the even blocks give cluster 12 the entry 3.9,
    past their hits, so the entry rule retires them after group 0 while the
    odd ones go on: the fused closest fold's sweep set (every block with k 8
    < n_cand) still sweeps them and takes the smaller id, the active blocks
    alone would not. signed_zero_tie: t_min 0, rays from the plane z = 1,
    cluster 10 (t +0.0) in group 0 and cluster 0 (t -0.0, smaller ids) in
    group 1, or the other way round by block."""
    nb = 40
    n = nb * t_lanes
    z0 = 1.0 if name == "signed_zero_tie" else -2.0
    o, d = _aimed_rays(rng, n, s, z0)
    tm = np.full((nb, t_lanes), np.inf, np.float32)
    t_min = 0.0 if name == "signed_zero_tie" else T_MIN
    far = [int(c) for c in range(1, 8)]
    orders, entries = [], []
    for b in range(nb):
        if name == "signed_zero_tie":
            first, second = (10, 0) if b % 2 else (0, 10)
            ent = [0.0] * 8 + [0.0]
        else:
            first, second = 0, 12
            late = 3.9 if name == "retired_tie" and b % 2 == 0 else 2.94
            ent = [2.94] + [_cascade_z(c) + 1.94 for c in far] + [late]
        orders.append([first] + far + [second] + [FUSED_C] * 7)
        entries.append(ent + [np.inf] * 7)
    return {"o": o.reshape(nb, t_lanes, 3), "d": d.reshape(nb, t_lanes, 3),
            "tm": tm, "t_min": t_min, "order": np.asarray(orders, np.int32),
            "n_cand": np.full(nb, 9, np.int32),
            "entry": np.asarray(entries, np.float32)}


def fused_cascade_case(name: str, s: int, t_lanes: int, seed: int = 0,
                       bad_id: bool = False) -> dict:
    """One crafted fused cascade in the layout of the fused cascades
    (cuda_cascade.fused_stage): fused_clusters' geometry (C = 13, the dummy
    is cluster 13), block rays o, d [nb, T, 3], tm [nb, T], t_min, rays [nb,
    8, T], order_g [nb, K, 8] i32 with every slot past a block's n_cand
    pointing at the dummy (prepare_fused_wave's padding), n_cand [nb] and
    entry [nb, K 8] f32. The first six cases are cascade_case's at g = 8;
    later_tie, retired_tie and signed_zero_tie are _tie_case's. bad_id: one
    slot of a swept group holds the id C + 2, outside [0, C]."""
    geo = fused_clusters(s)
    if name in CASCADE_CASES:
        case = cascade_case(name, s, t_lanes, FUSED_G, seed)
        nb = case["n_cand"].shape[0]
        order = case["order_g"].reshape(nb, -1)
        cols = np.arange(order.shape[1])
        order = np.where(cols[None] < case["n_cand"][:, None], order,
                         FUSED_C).astype(np.int32)
        case = {k: case[k] for k in ("o", "d", "tm", "t_min", "n_cand",
                                     "entry")}
        case["order"] = order
    else:
        rng = np.random.default_rng([seed, s, t_lanes,
                                     600 + FUSED_CASES.index(name)])
        case = _tie_case(name, s, t_lanes, rng)
    order = case.pop("order")
    nb = order.shape[0]
    if bad_id:
        live = np.flatnonzero(case["n_cand"] > 0)
        order[live[len(live) // 2], 0] = FUSED_C + 2
    tm = case["tm"]
    rays = np.concatenate([case["o"].transpose(0, 2, 1),
                           case["d"].transpose(0, 2, 1), tm[:, None],
                           np.full_like(tm, case["t_min"])[:, None]], 1)
    return {**geo, **case, "rays": np.ascontiguousarray(rays, np.float32),
            "order_g": np.ascontiguousarray(order.reshape(nb, -1, FUSED_G)),
            "entry": np.ascontiguousarray(case["entry"], np.float32)}


# --- the perray cases: whole perray cascades, blocks of one ray -------------

PERRAY_CASES = ("dead_and_zero", "no_candidates", "exhausted", "group_ties",
                "filler_hit", "cap_over_c", "signed_zero")
PERRAY_G = (1, 4, 8)    # clusters a group
PERRAY_S = (2, 128)     # triangles a cluster
PERRAY_RAYS = 256
PERRAY_MIN_BLOCKS = 32  # stages of 256, 128, 64 and 32 rays


def _perray_row(cand, c_n: int, cap: int) -> list:
    """A ray's candidate row as traverse._perray_candidates builds it in id
    mode: the candidates, then C - 1 up to C, then 0 up to cap."""
    cand = [int(c) for c in cand][:cap]
    return (cand + [c_n - 1] * max(0, min(cap, c_n) - len(cand))
            + [0] * max(0, cap - max(c_n, len(cand))))


def perray_case(name: str, s: int, g: int, seed: int = 0,
                n: int = PERRAY_RAYS) -> dict:
    """One crafted perray cascade in the layout of the perray stage
    (cuda_cascade.perray_stage, blocks of one ray): fused_clusters'
    geometry (C = 13; cluster 12, the filler id C - 1, is cluster 0 again
    with smaller ids), rays o, d [n, 3], tm [n], t_min, rays [n, 8, 1]
    (traverse.pack_block_rays' layout), order_g [n, K, g] i32 (K =
    ceil(cap / g), _perray_row's rows padded with 0), n_cand [n] i32 and
    cap. Rays from z = -2 through the unit square (cluster 0's plane z = 1
    the nearest but cluster 11's) unless said otherwise. Cases:

    dead_and_zero: t_max -1, -0.0, +0.0, NaN, inf and [3.5, 12] in turn:
      the closest fold's rule retires the dead and NaN rays at once, the
      any-hit fold's keeps them until they run out of candidates.
    no_candidates: every third ray has n_cand 0 (an overflowed ray's row).
    exhausted: n_cand = ray % (C + 1), every other ray short of every plane
      (t_max 0.5): rays run out of candidates at every k.
    group_ties: rays aimed through cluster 0's triangles, cluster 0 first
      in group 0 and its copy 12 (smaller ids) first in group 1, or the
      other way round, far clusters (1-9) elsewhere: an exact t tie across
      groups, which the first group keeps.
    filler_hit: t_max inf, n_cand = 1 + ray % g far clusters: the nearer
      filler C - 1 past n_cand in the last swept group gives the hit.
    cap_over_c: cap C + 3, columns past C hold cluster 0 (a real one) and
      are swept with the group that holds them.
    signed_zero: t_min 0, rays from the plane z = 1 through cluster 0's
      triangles, cluster 0 (t -0.0) and cluster 10 (t +0.0) first in
      groups 0 and 1 in either order: exact ties of signed zeros."""
    rng = np.random.default_rng([seed, s, g, 700 + PERRAY_CASES.index(name)])
    geo = fused_clusters(s)
    c_n = FUSED_C
    cap = c_n + 3 if name == "cap_over_c" else c_n
    o, d, tm = _rays(rng, n, s)
    t_min = T_MIN
    if name in ("group_ties", "signed_zero"):
        o, d = _aimed_rays(rng, n, s, 1.0 if name == "signed_zero" else -2.0)
        tm[:] = np.inf
    if name == "signed_zero":
        t_min = 0.0
    far = list(range(1, 10))
    rows, ncs = [], []
    for r in range(n):
        if name in ("group_ties", "signed_zero"):
            pair = (0, 12) if name == "group_ties" else (0, 10)
            first, second = pair[::-1] if r % 2 else pair
            fill = [int(c) for c in rng.choice(far, 2 * g - 2, replace=False)
                    ] if 2 * g - 2 <= len(far) else list(far)
            cand = [first] + fill[:g - 1] + [second]
        elif name == "filler_hit":
            cand = sorted(rng.choice(far, 1 + r % g, replace=False))
        else:
            cand = sorted(rng.choice(c_n, int(rng.integers(0, c_n + 1)),
                                     replace=False))
            if name == "no_candidates" and r % 3 == 0:
                cand = []
            if name == "exhausted":
                cand = sorted(rng.choice(c_n, r % (c_n + 1), replace=False))
        rows.append(_perray_row(cand, c_n, cap))
        ncs.append(min(len(cand), cap))
    if name == "dead_and_zero":
        for i, v in enumerate((-1.0, -0.0, 0.0, np.nan, np.inf)):
            tm[i::6] = v
    if name == "exhausted":
        tm[::2] = 0.5
    if name == "filler_hit":
        tm[:] = np.inf
    k_groups = -(-cap // g)
    order = np.pad(np.asarray(rows, np.int32),
                   ((0, 0), (0, k_groups * g - cap)))
    rays = np.concatenate([o, d, tm[:, None], np.full((n, 1), t_min)], 1)
    return {**geo, "o": o, "d": d, "tm": tm, "t_min": t_min, "cap": cap,
            "rays": np.ascontiguousarray(rays[:, :, None], np.float32),
            "order_g": np.ascontiguousarray(order.reshape(n, k_groups, g)),
            "n_cand": np.asarray(ncs, np.int32)}


# --- a scene whose cull entry is not conservative in f32 --------------------

TIE_SCENE_S = 16
TIE_SCENE_Z = 8.5  # the plane of the tied triangles


def fused_tie_scene(seed: int = 0) -> dict:
    """A scene on which the fused closest cascade's sweep set decides an
    exact tie, with the port's own cull. Nine clusters of TIE_SCENE_S
    slots (padding: zero triangles, id -1), each box the bounds of its
    triangles: cluster 0 one triangle X over half the unit square in the
    plane z = TIE_SCENE_Z (id 50), clusters 1-7 two tiny triangles at
    opposite corners of the unit square in the plane z = c (their boxes
    the unit square), cluster 8 X again with id 10. A wave of 256 rays,
    all dead but lane 0 (block 0), which meets X and its copy at the same
    t, and lane 128 (block 1), which crosses every box and meets nothing.
    Lane 0's direction is drawn until the Möller–Trumbore t of X (f =
    1 / det, t = f (o - v0)_z) falls below the slab entry of X's box
    ((z - o_z) / d_z, the interval cull's): then cluster 8, in block 0's
    second group, has an entry past block 0's best hit, the entry rule
    retires block 0 after its first group while block 1 goes on, and only
    a sweep set that keeps every block with k 8 < n_cand (the JAX
    package's) finds the copy's smaller id. Returns the accel's arrays
    (bmin, bmax, v0, e1, e2, tri_id, scene_min, scene_max, sbmin, sbmax,
    cbmin, cbmax), origins, directions, t_max, t_min, and the tie's t."""
    rng = np.random.default_rng([seed, 17])
    f32 = np.float32
    s, c_n, zx = TIE_SCENE_S, 9, f32(TIE_SCENE_Z)
    v0 = np.zeros((c_n, s, 3), f32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    tri_id = np.full((c_n, s), -1, np.int32)
    for c in (0, 8):
        v0[c, 0] = (0.0, 0.0, zx)
        e1[c, 0] = (1.0, 0.0, 0.0)
        e2[c, 0] = (0.0, 1.0, 0.0)
    tri_id[0, 0], tri_id[8, 0] = 50, 10
    for c in range(1, 8):
        v0[c, 0] = (0.0, 0.0, c)
        e1[c, 0] = (0.05, 0.0, 0.0)
        e2[c, 0] = (0.0, 0.05, 0.0)
        v0[c, 1] = (1.0, 1.0, c)
        e1[c, 1] = (-0.05, 0.0, 0.0)
        e2[c, 1] = (0.0, -0.05, 0.0)
        tri_id[c, :2] = (100 + 2 * c, 101 + 2 * c)
    real = tri_id >= 0
    verts = np.concatenate([v0, v0 + e1, v0 + e2], axis=1)
    mask = np.concatenate([real] * 3, axis=1)[..., None]
    bmin = np.where(mask, verts, np.inf).min(axis=1).astype(f32)
    bmax = np.where(mask, verts, -np.inf).max(axis=1).astype(f32)
    while True:
        d = rng.normal(size=3) * np.asarray([0.02, 0.02, 1.0])
        d[2] = abs(d[2])
        d = (d / np.linalg.norm(d)).astype(f32)
        oz = f32(rng.uniform(0.2, 0.8))
        t = f32(f32(f32(1.0) / f32(-d[2])) * f32(oz - zx))
        entry = f32(f32(zx - oz) / d[2])
        if t < entry:
            break
    n = 256
    o = np.zeros((n, 3), f32)
    dirs = np.tile(np.asarray([0.0, 0.0, 1.0], f32), (n, 1))
    o[0] = (f32(0.3) - t * d[0], f32(0.3) - t * d[1], oz)
    dirs[0] = d
    o[128] = (0.7, 0.7, oz)
    dirs[128] = d
    tm = np.full(n, -1.0, f32)
    tm[[0, 128]] = np.inf
    lo, hi = bmin.min(axis=0), bmax.max(axis=0)
    arrays = (bmin, bmax, v0, e1, e2, tri_id, lo, hi, lo[None], hi[None],
              bmin[None], bmax[None])
    return {"accel": arrays, "o": o, "d": dirs, "tm": tm, "t_min": T_MIN,
            "t": t}


# One triangle and a ray that meets it exactly at its vertex v0, a corner
# of its box, after t = GATE_T: found by a search of random triangles in
# [-1, 1]^3 and rays of t in [0.001, 0.1] that end on a vertex. The ray
# passes the corner within rounding of it, and with the window's end at the
# test's own t its f32 slab entry lies past t by more than 2^-16 of t, so a
# gate on the box itself, or on its end widened by 2^-16 of itself, skips
# the hit; the box grown by a few hundred ulps of its coordinates
# (cuda_closest.gate_lanes) does not.
_hex = float.fromhex
GATE_V = tuple(tuple(map(_hex, v)) for v in (
    ("-0x1.6e0eecp-7", "-0x1.6cf0f6p-9", "-0x1.e7f9p-1"),
    ("-0x1.e1030ap-2", "-0x1.d7974ap-1", "-0x1.e9832ep-2"),
    ("-0x1.524058p-1", "0x1.c28252p-1", "-0x1.1fed48p-1")))
GATE_O = tuple(map(_hex, ("-0x1.1736c4p-5", "-0x1.755258p-5",
                          "-0x1.02b92ep+0")))
GATE_D = tuple(map(_hex, ("0x1.379936p-2", "0x1.22f128p-1",
                          "0x1.877002p-1")))
GATE_T = _hex("0x1.346a98p-4")
GATE_S = 32  # one sub-slab


def _one_triangle_block(v, o, d, t_end, t_lanes, s, centre_lane):
    """One cluster of s slots (the triangle v, id 7, then zero triangles,
    id -1) and one block of t_lanes lanes for block_closest: lane 0 the ray
    (o, d), its window ending at t_end; lane centre_lane (unless None) a
    ray through the box's centre with t_max +inf; the others dead."""
    f32 = np.float32
    p = np.asarray(v, f32)
    v0 = np.zeros((1, s, 3), f32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    v0[0, 0], e1[0, 0], e2[0, 0] = p[0], p[1] - p[0], p[2] - p[0]
    tri_id = np.full((1, s), -1, np.int32)
    tri_id[0, 0] = 7
    verts = np.stack([v0[0, 0], v0[0, 0] + e1[0, 0], v0[0, 0] + e2[0, 0]])
    bmin = verts.min(axis=0)[None].astype(f32)
    bmax = verts.max(axis=0)[None].astype(f32)
    rays = np.zeros((1, 8, t_lanes), f32)
    rays[0, 5] = 1.0
    rays[0, 6] = -1.0
    rays[0, 7] = T_MIN
    rays[0, 0:3, 0] = o
    rays[0, 3:6, 0] = d
    rays[0, 6, 0] = t_end
    if centre_lane is not None:
        centre = (bmin[0] + bmax[0]) / 2
        rays[0, 0:3, centre_lane] = centre - np.asarray([0.0, 0.0, 4.0], f32)
        rays[0, 6, centre_lane] = np.inf
    cid8 = np.ones(8, np.int32)
    cid8[0] = 0
    return {"bmin": bmin, "bmax": bmax, "v0": v0, "e1": e1, "e2": e2,
            "tri_id": tri_id, "rays": rays, "cid8": cid8}


def gate_corner_case(t_lanes: int = 64, s: int = GATE_S) -> dict:
    """One cluster of s slots (the triangle, id 7, then zero triangles, id
    -1) and one block of t_lanes lanes for block_closest:
    lane 0 the corner ray, its window ending at GATE_T, as a running best
    of that t would end it (an exact tie there must be found); lane 32 a ray
    through the box's centre (its own gate passes, so a vote over the whole
    block sweeps the sub-slab); the others dead. Returns the accel's
    arrays (bmin, bmax, v0, e1, e2, tri_id), rays [1, 8, t_lanes] and cid8
    [8] (cluster 0, then the dummy, id 1)."""
    return _one_triangle_block(GATE_V, GATE_O, GATE_D, GATE_T, t_lanes, s,
                               32)


# Two grazing rays, each found by a search of random triangles in
# [-1, 1]^3 and rays at cos(ray, normal) = 1.0e-3 that end near a vertex,
# far under the cos x sin(smallest angle) of ~0.1 that the port's closest
# gate covers (csrc/mt.cuh gate_lane). At such angles the rounding of the
# Möller–Trumbore t moves the test's point o + t d along the ray by
# ~1e-4 of t, out of the triangle's box: with the window ending at that
# t, as a running best of that t would end it, the sub-slab's gate skips
# the hit that an ungated sweep finds. Each package rounds t its own way
# (XLA's CPU code contracts FMAs, the port does not), so each has its own
# ray: GRAZE_* the port's (its t, GRAZE_T, lies 3.3e-5 outside the box in
# y, past the grown box's pad of 2^-16 x 2.04 = 3.1e-5; cos x sin =
# 1.7e-4), JGRAZE_* the JAX package's (JGRAZE_T: block_closest's own t in
# interpret mode in a block of 128 lanes, which the search used: XLA's
# rounding of it depends on the block's width; its gate is the box
# itself).
GRAZE_V = tuple(tuple(map(_hex, v)) for v in (
    ("-0x1.4f52e8p-3", "0x1.302a70p-1", "-0x1.7f9b5ep-2"),
    ("0x1.0bbbdap-2", "0x1.2d5f84p-1", "-0x1.e49c24p-1"),
    ("-0x1.a7b5c0p-1", "0x1.3aa060p-5", "0x1.0c4318p-1")))
GRAZE_O = tuple(map(_hex, ("-0x1.e8c4acp-2", "0x1.1bd5f0p+0",
                           "0x1.4de3b4p-5")))
GRAZE_D = tuple(map(_hex, ("0x1.b6b400p-2", "-0x1.6801f8p-1",
                           "-0x1.228e96p-1")))
GRAZE_T = _hex("0x1.76bb56p-1")
JGRAZE_V = tuple(tuple(map(_hex, v)) for v in (
    ("-0x1.3e81e6p-2", "0x1.21959ap-1", "-0x1.15a022p-1"),
    ("0x1.333e80p-6", "-0x1.b0d4acp-2", "-0x1.5a5364p-3"),
    ("-0x1.fd19a4p-1", "-0x1.b71d60p-3", "-0x1.610182p-1")))
JGRAZE_O = tuple(map(_hex, ("-0x1.30525cp-3", "0x1.560baap+0",
                            "-0x1.46775ep-1")))
JGRAZE_D = tuple(map(_hex, ("-0x1.a36c52p-3", "-0x1.f159dcp-1",
                            "0x1.ec95b0p-4")))
JGRAZE_T = _hex("0x1.962032p-1")


def grazing_case(which: str, rescue: bool, t_lanes: int = 128,
                 s: int = GATE_S) -> dict:
    """gate_corner_case's layout for a grazing ray (lane 0): the port's
    (which "port": GRAZE_*, its window ending at GRAZE_T) or the JAX
    package's ("jax": JGRAZE_*, at JGRAZE_T), alone in its block (the
    others dead), or, with `rescue`, beside a lane 32 whose ray passes
    through the box's centre, so that a gate voted over the whole block
    (the JAX package's) sweeps the sub-slab for lane 0 too. Also "v" (the
    triangle), "t" (the window's end)."""
    v, o, d, t = ((GRAZE_V, GRAZE_O, GRAZE_D, GRAZE_T) if which == "port"
                  else (JGRAZE_V, JGRAZE_O, JGRAZE_D, JGRAZE_T))
    return {**_one_triangle_block(v, o, d, t, t_lanes, s,
                                  32 if rescue else None), "v": v, "t": t}


# ---- ctiles' static slot tables (slot_sweep) ----------------------------

SLOT_CASES = ("ties", "t_min_hit", "signed_zero", "spread", "padding",
              "no_tiles")
SLOT_C = 4
SLOT_CAP = 4  # pair p = row * SLOT_CAP + k
# (slots a tile, lanes a row): ctiles' closest tiles (T 128) and lane-major
# shadow tiles (T 64), the pair tiles (one lane a row, T 128), and a shape
# that only the generic instance takes (T 16)
SLOT_SHAPES = ((16, 8), (16, 4), (128, 1), (2, 8))


def exact_clusters(s: int) -> dict:
    """v0, e1, e2 [4, S, 3] f32 and tri_id [4, S] i32: S right triangles a
    cluster over a grid of cells 2^-k wide, legs c = half a cell, every
    coordinate exact. Clusters 0 and 1 hold the same triangles in the plane
    z = 2, wound one way and the other (cluster 1 with the smaller ids): a
    ray along +z from z = 0 meets both at t = 2 exactly, and one that starts
    in the plane meets cluster 0 at t = -0.0 and cluster 1 at +0.0.
    Cluster 2 lies at z = 3, cluster 3 at z = 1.5."""
    w = 1
    while w * w < s:
        w *= 2
    cell = 1.0 / w
    j = np.arange(s)
    v0 = np.zeros((SLOT_C, s, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    for c, z in enumerate((2.0, 2.0, 3.0, 1.5)):
        v0[c, :, 0] = (j % w) * cell
        v0[c, :, 1] = (j // w) * cell
        v0[c, :, 2] = z
        a, b = (1, 0) if c == 1 else (0, 1)
        e1[c, :, a] = 0.5 * cell
        e2[c, :, b] = 0.5 * cell
    tri_id = (np.array([3, 0, 1, 2])[:, None] * s + j[None, :] + 7)
    return {"v0": v0, "e1": e1, "e2": e2, "tri_id": tri_id.astype(np.int32)}


def _slot_rows(name: str, tb: int) -> list:
    """Each row's candidate clusters, in pair order."""
    if name == "spread":
        return [[0, 1, 2, 3]] * (3 * tb + 1)
    if name == "padding":
        return [[0], [1, 2], [3]]
    if name == "signed_zero":
        return [[0, 1], [1, 0], [0, 1, 2], [2, 1, 0]]
    return [[0, 1], [1, 0, 2], [2, 0, 1, 3], [1]]


def slot_tables(rows: list, c: int, cap: int, tb: int):
    """(slot_ref [ni_pad], slot_cid [ni_pad], n_slots): accel.ctiles'
    _build_pairs in numpy. Pair p = row * cap + k, sorted by cluster (within
    a cluster by p), each cluster's run padded with -1 to whole tiles of tb
    slots; ni_pad = rows * cap + tb * C rounded up to whole tiles; slots
    past the live ones hold -1 and the last cluster id."""
    pairs = sorted((cid, r * cap + k) for r, ks in enumerate(rows)
                   for k, cid in enumerate(ks))
    ref, cids = [], []
    for cl in range(c):
        run = [p for cid, p in pairs if cid == cl]
        run += [-1] * ((-len(run)) % tb)
        ref += run
        cids += [cl] * len(run)
    n_slots = len(ref)
    ni_pad = -(-(len(rows) * cap + tb * c) // tb) * tb
    last = cids[-1] if cids else 0
    ref += [-1] * (ni_pad - n_slots)
    cids += [last] * (ni_pad - n_slots)
    return (np.asarray(ref, np.int32), np.asarray(cids, np.int32), n_slots)


def slot_case(name: str, s: int, tb: int, b: int, seed: int = 0) -> dict:
    """One slot_sweep input over exact_clusters(s): rays [rows + 1, 8, b]
    (row `rows` dead: o 0, d 1, t_max -1), slot_ref / slot_cid (tile i's
    cluster at slot_cid[i * tb]), n_tiles, tb, cap. Every lane of a row aims
    at its own triangle, along +z from z = 0 (t = 2 at clusters 0 and 1),
    from the plane z = 2 with t_min 0 (signed_zero) or with t_min = 2
    (t_min_hit); padding kills every third lane and row 1."""
    rng = np.random.default_rng([seed, s, tb, b, SLOT_CASES.index(name)])
    geo = exact_clusters(s)
    rows = _slot_rows(name, tb)
    nr = len(rows)
    w = 1
    while w * w < s:
        w *= 2
    c = 0.5 / w
    tri = rng.integers(0, s, (nr, b))
    o = np.zeros((nr, b, 3), np.float32)
    o[..., 0] = geo["v0"][0, tri, 0] + c / 4
    o[..., 1] = geo["v0"][0, tri, 1] + c / 8 * (1 + np.arange(b) % 3)
    o[..., 2] = 2.0 if name == "signed_zero" else 0.0
    d = np.zeros_like(o)
    d[..., 2] = 1.0
    tm = np.full((nr, b), 10.0, np.float32)
    t_min = {"t_min_hit": 2.0, "signed_zero": 0.0}.get(name, T_MIN)
    if name == "padding":
        tm.reshape(-1)[::3] = -1.0
        tm[1] = -1.0
    tmin = np.full((nr, b), t_min, np.float32)
    table = np.concatenate([o.transpose(0, 2, 1), d.transpose(0, 2, 1),
                            tm[:, None], tmin[:, None]], axis=1)
    dead = np.zeros((1, 8, b), np.float32)
    dead[0, 3:6] = 1.0
    dead[0, 6] = -1.0
    dead[0, 7] = t_min
    ref, cid, n_slots = slot_tables(rows, SLOT_C, SLOT_CAP, tb)
    return {**geo, "rays": np.ascontiguousarray(
                np.concatenate([table, dead]), np.float32),
            "slot_ref": ref, "slot_cid": cid,
            "n_tiles": 0 if name == "no_tiles" else n_slots // tb,
            "tb": tb, "cap": SLOT_CAP, "t_min": t_min}


# ---- the packet cascades' interval cull (cull_case) -----------------------

CULL_CASES = ("coherent", "dead_blocks", "axis_parallel", "inside",
              "signed_zero", "flat", "all_candidates", "inf_tmax", "ties",
              "inf_entry")
# (blocks, rays a block, clusters): C 150 and 70 are not multiples of the
# cascades' group sizes (2, 8)
CULL_SIZES = ((16, 16, 150), (8, 64, 300), (64, 4, 70))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def cull_case(name: str, nb: int, r: int, c: int, seed: int = 0) -> dict:
    """One interval-cull input: o, d [nb, r, 3], tm [nb, r] (t_max;
    negative: dead), bmin, bmax [c, 3], all f32. Blocks are coherent (a
    base origin and direction, lanes jittered; every seventh lane dead)
    unless the case says otherwise:
    dead_blocks: block 0 all dead, block 1 half dead at the placeholder ray
      (o 0, d +x), block 2 one live lane, block 3 t_max exactly 0;
    axis_parallel: d = +-e_a with +0.0 / -0.0 in the other components
      (some blocks all +0.0), origins on box planes;
    inside: origins at the centre of nested boxes (entries tie at 0);
    signed_zero: origins on the plane x = 0.5 of flat boxes, going -x, so
      that lb is -0.0 and ties with +0.0 entries;
    flat: every box flat on one axis;
    all_candidates: every block's directions span 0 on each axis and t_max
      is +inf: every cluster is a candidate at entry 0;
    inf_tmax: live lanes at t_max = +inf (a closest query);
    ties: each box repeated at scattered ids (equal entries above 0);
    inf_entry: directions of x ~ 1e-30 (y, z spanning 0) and t_max +inf:
      boxes far along x give lb = ub = +inf, candidates at entry +inf."""
    rng = np.random.default_rng([seed, nb, r, c, CULL_CASES.index(name)])
    centre = rng.uniform(-1.0, 1.0, (c, 3))
    half = rng.uniform(0.02, 0.2, (c, 3))
    if name == "ties":
        pick = rng.integers(0, max(1, c // 3), c)
        centre, half = centre[pick], half[pick]
    if name == "inside":
        k = min(c, 12)
        centre[:k] = centre[0]
        half[:k] = 0.05 * np.arange(1, k + 1)[:, None]
    bmin = (centre - half).astype(np.float32)
    bmax = (centre + half).astype(np.float32)
    if name == "flat":
        axis = rng.integers(0, 3, c)
        bmax[np.arange(c), axis] = bmin[np.arange(c), axis]

    base_o = rng.uniform(-2.0, 2.0, (nb, 1, 3))
    base_d = _unit(rng.standard_normal((nb, 1, 3)))
    o = base_o + rng.normal(0.0, 0.05, (nb, r, 3))
    d = _unit(base_d + rng.normal(0.0, 0.05, (nb, r, 3)))
    tm = rng.uniform(0.5, 4.0, (nb, r))
    tm.reshape(-1)[::7] = -1.0
    if name == "dead_blocks":
        tm[0] = -1.0
        if nb > 1:
            tm[1, ::2] = -1.0
            o[1, ::2] = 0.0
            d[1, ::2] = (1.0, 0.0, 0.0)
        if nb > 2:
            tm[2, 1:] = -1.0
            tm[2, 0] = 2.0
        if nb > 3:
            tm[3] = 0.0
    elif name == "axis_parallel":
        axis = rng.integers(0, 3, nb)
        sign = rng.choice([-1.0, 1.0], nb)
        zeros = np.where(rng.uniform(size=(nb, r, 3)) < 0.5, -0.0, 0.0)
        zeros[::3] = 0.0  # every third block: only +0.0
        d = zeros
        d[np.arange(nb), :, axis] = sign[:, None]
        box = rng.integers(0, c, (nb, r))
        o[np.arange(nb)[:, None], np.arange(r)[None], axis[:, None]] = \
            bmin[box, axis[:, None]]
    elif name == "inside":
        o = centre[0] + rng.normal(0.0, 1e-3, (nb, r, 3))
    elif name == "signed_zero":
        k = min(c, 10)
        bmin[:k, 0] = bmax[:k, 0] = 0.5
        bmin[:k, 1:] = -3.0
        bmax[:k, 1:] = 3.0
        o[..., 0] = 0.5
        d = np.stack([-rng.uniform(0.5, 1.0, (nb, r)),
                      rng.uniform(-0.5, 0.5, (nb, r)),
                      rng.uniform(-0.5, 0.5, (nb, r))], axis=-1)
        d[:, 0, 1:] = (0.2, 0.2)
        d[:, 1 % r, 1:] = (-0.2, -0.2)
    elif name == "all_candidates":
        d[:, 0] = _unit(np.ones(3))
        d[:, 1 % r] = -_unit(np.ones(3))
        tm = np.full((nb, r), np.inf)
        tm[:, 2:] = -1.0 if r > 2 else np.inf
    elif name == "inf_tmax":
        tm = np.where(tm >= 0.0, np.inf, tm)
    elif name == "inf_entry":
        far = rng.uniform(size=c) < 0.3
        bmin[far, 0] = np.float32(1e10)
        bmax[far, 0] = np.float32(2e10)
        o = base_o + rng.normal(0.0, 0.05, (nb, r, 3))
        o[..., 0] = -1.0 - np.abs(o[..., 0])
        d = np.zeros((nb, r, 3))
        d[..., 0] = rng.uniform(1e-30, 2e-30, (nb, r))
        d[..., 1] = np.where(np.arange(r) % 2, 1e-3, -1e-3)
        d[..., 2] = np.where(np.arange(r) % 3 == 1, 1e-3, -1e-3)
        if r == 1:
            d[..., 1:] = 0.0
        tm = np.where(tm >= 0.0, np.inf, tm)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return {"o": f(o), "d": f(d), "tm": f(tm), "bmin": f(bmin),
            "bmax": f(bmax)}


# ---- the worklist's cull (wl_cull_case) -----------------------------------

WL_CULL_CASES = ("cap_edge", "super_edge", "dead_and_nan", "axis_signed_zero",
                 "phantoms", "small_c", "flat_past_2048", "block_1",
                 "block_64")
WL_LINE_D = (1.0, 0.01, 0.02)  # the direction of every line case's rays


def wl_supers(bmin, bmax, ss: int) -> dict:
    """The 2-level boxes of accel.clusters.build_clusters: supers of ss
    consecutive clusters, the padding children of a partly filled last
    super inverted (+-3e37), each super the union of its children."""
    c = bmin.shape[0]
    cs = -(-c // ss)
    big = np.float32(3.0e37)
    cbmin = np.full((cs * ss, 3), big, np.float32)
    cbmax = np.full((cs * ss, 3), -big, np.float32)
    cbmin[:c] = bmin
    cbmax[:c] = bmax
    cbmin = cbmin.reshape(cs, ss, 3)
    cbmax = cbmax.reshape(cs, ss, 3)
    return {"sbmin": cbmin.min(axis=1), "sbmax": cbmax.max(axis=1),
            "cbmin": cbmin, "cbmax": cbmax}


def _line_boxes(n_on: int, n_ids: int, k: int):
    """n_ids boxes of half 0.05 along line k (origin (0, 6k, 3k), direction
    WL_LINE_D): n_on at t = 1 .. n_on, the rest past t = n_on + 10, beyond
    the line's rays' t_max (n_on + 2)."""
    d = _unit(np.asarray(WL_LINE_D))
    t = np.concatenate([np.arange(1, n_on + 1),
                        n_on + 10 + np.arange(n_ids - n_on)])
    centre = np.array([0.0, 6.0 * k, 3.0 * k]) + t[:, None] * d
    return centre - 0.05, centre + 0.05


def _line_rays(rng, k: int, n_on: int, b: int):
    """One block of b rays along line k, jittered, t_max n_on + 2."""
    d = _unit(np.asarray(WL_LINE_D))
    o = np.array([0.0, 6.0 * k, 3.0 * k]) + rng.normal(0.0, 1e-3, (b, 3))
    dd = _unit(d + rng.normal(0.0, 1e-4, (b, 3)))
    return o, dd, np.full(b, n_on + 2.0)


def _coherent_rays(rng, nb: int, b: int):
    base_o = rng.uniform(-1.2, 1.2, (nb, 1, 3))
    base_d = _unit(rng.standard_normal((nb, 1, 3)))
    o = base_o + rng.normal(0.0, 0.05, (nb, b, 3))
    d = _unit(base_d + rng.normal(0.0, 0.05, (nb, b, 3)))
    tm = rng.uniform(0.5, 4.0, (nb, b))
    tm.reshape(-1)[::7] = -1.0
    return o, d, tm


def _random_boxes(rng, c: int, half=(0.02, 0.2), offset=0.0):
    centre = rng.uniform(-1.0, 1.0, (c, 3)) + offset
    h = rng.uniform(*half, (c, 3))
    return centre - h, centre + h


def wl_cull_case(name: str, seed: int = 0) -> dict:
    """One worklist-cull input: o, d [nb, B, 3], tm [nb, B] (t_max; negative
    or NaN: dead), bmin, bmax [C, 3] and their supers of `ss` (wl_supers),
    all f32, with the case's cap, super_cap and levels (the levels it is
    held at). The line cases lay clusters along lines far apart (each
    line's on-path boxes, then boxes past its rays' t_max filling its last
    super), so that a line's blocks have exactly its on-path boxes as
    candidates, and fill the rest with random boxes far from the lines:
    cap_edge: C 70 (not a multiple of 32), cap 6: blocks with exactly 6
      candidates and blocks with 7 (overflow);
    super_edge: supers of 4, super_cap 3, cap 64: blocks whose candidates
      fill exactly 3 supers and blocks that reach 4 (overflow at levels 2),
      k_eff clamped to super_cap * super_size = 12 below cap and C;
    dead_and_nan: an all-dead block, a block with a NaN t_max lane, one
      with a dead lane whose origin is NaN, one with a live lane whose
      direction has a NaN, one at t_max exactly 0;
    axis_signed_zero: random boxes, directions +-e_a with +0.0 / -0.0 in
      the other components (some blocks all -0.0), origins on box planes;
    phantoms: C 49 = 3 * 16 + 1 in supers of 16: the last super holds one
      real cluster and 15 padding children, which count at levels 2;
    small_c: C 20 < 32, random boxes and coherent blocks;
    flat_past_2048: C 2,100 small random boxes, held at levels 1 too;
    block_1, block_64: coherent blocks of 1 and 64 rays."""
    rng = np.random.default_rng([seed, WL_CULL_CASES.index(name)])
    nb, b, ss, cap, super_cap, levels = 16, 8, 4, 64, 32, (1, 2)
    lines = []  # (n_on, n_ids) of line k, clusters in line order first
    if name == "cap_edge":
        cap, lines, c = 6, [(6, 8), (7, 8)], 70
    elif name == "super_edge":
        super_cap, lines, c = 3, [(12, 12), (16, 16)], 70
    elif name == "dead_and_nan":
        lines, c = [(5, 8)], 40
    elif name == "phantoms":
        ss, lines, c = 16, [(10, 16)], 49
    elif name == "small_c":
        c = 20
    elif name == "flat_past_2048":
        c, levels = 2100, (1, 2)
    else:
        c = 70
    if name == "block_1":
        b = 1
    elif name == "block_64":
        b = 64

    n_line = sum(n for _on, n in lines)
    if name == "flat_past_2048":
        bmin, bmax = _random_boxes(rng, c, half=(0.002, 0.02))
    else:
        bmin, bmax = _random_boxes(rng, c)
    if lines:
        # the random boxes move far from the lines (y, z about -30)
        bmin[n_line:] += (0.0, -30.0, -30.0)
        bmax[n_line:] += (0.0, -30.0, -30.0)
        at = 0
        for k, (n_on, n_ids) in enumerate(lines):
            bmin[at:at + n_ids], bmax[at:at + n_ids] = _line_boxes(
                n_on, n_ids, k)
            at += n_ids
    if name == "phantoms":
        # the last cluster, alone in its super, on a line of its own
        bmin[c - 1:], bmax[c - 1:] = _line_boxes(1, 1, len(lines))

    o, d, tm = _coherent_rays(rng, nb, b)
    if lines or name == "phantoms":
        n_lines = len(lines) + (name == "phantoms")
        for i in range(nb):
            k = i % n_lines
            n_on = lines[k][0] if k < len(lines) else 1
            o[i], d[i], tm[i] = _line_rays(rng, k, n_on, b)
    if name == "dead_and_nan":
        tm[0] = -1.0
        tm[1, 3] = np.nan
        o[2, 2] = np.nan
        tm[2, 2] = -1.0
        d[3, 5, 1] = np.nan
        tm[4] = 0.0
    elif name == "axis_signed_zero":
        axis = rng.integers(0, 3, nb)
        sign = rng.choice([-1.0, 1.0], nb)
        zeros = np.where(rng.uniform(size=(nb, b, 3)) < 0.5, -0.0, 0.0)
        zeros[::4] = -0.0  # every fourth block: only -0.0
        d = zeros
        d[np.arange(nb), :, axis] = sign[:, None]
        box = rng.integers(0, c, (nb, b))
        o[np.arange(nb)[:, None], np.arange(b)[None], axis[:, None]] = \
            bmin[box, axis[:, None]]
        tm = np.where(tm >= 0.0, 8.0, tm)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return {"o": f(o), "d": f(d), "tm": f(tm), "bmin": f(bmin),
            "bmax": f(bmax), **wl_supers(f(bmin), f(bmax), ss), "ss": ss,
            "cap": cap, "super_cap": super_cap, "levels": levels}


# ---- the per-ray culls (ray_cull_case) ------------------------------------

RAY_CULL_CASES = ("t_max_values", "axis_on_plane", "signed_zero", "flat_boxes",
                  "count_edges", "phantoms", "small_c", "pad_rule")


def _place_line(bmin, bmax, ids, k, n_on):
    """Clusters `ids` on line k (_line_boxes): the first n_on on the path
    at t = 1 .. n_on, the rest past its rays' t_max."""
    lo, hi = _line_boxes(n_on, len(ids), k)
    bmin[ids], bmax[ids] = lo, hi


def ray_cull_case(name: str, seed: int = 0) -> dict:
    """One per-ray cull input for kslots' cull (accel.cuda_cull
    kslots_cull) and perray's (perray_cull): rays o, d [N, 3], tm [N]
    (t_max), t_min, boxes bmin, bmax [C, 3] and their supers of `ss`
    (wl_supers), all f32, with the case's k_supers (ks), k_clusters (kc)
    and cap (perray). Held at those and one past each. The line cases lay
    clusters along lines far apart (_line_boxes), so that a line's rays
    have exactly its on-path clusters as candidates, and move the other,
    random boxes far from the lines:
    t_max_values: t_min 0, C 70 random boxes, t_max cycling through -1,
      -0.0, +0.0, NaN, +inf and [0.5, 4]; every fourth ray starts at a
      box's centre (a candidate at entry 0, also at t_max -0.0);
    axis_on_plane: d = +-e_a with +0.0 in the other components and the
      origin on a box's plane of one of those axes (0 x inf = NaN in the
      slab);
    signed_zero: one or two direction components +0.0 or -0.0 (1 / -0.0
      = -inf, negative), origins on box planes;
    flat_boxes: every box flat on one axis (kept by the inclusive test);
    count_edges: C 70 in supers of 4, ks 2, kc 6, cap 6: a line with 6
      candidates in 2 supers (exactly kc, cap and ks), one with 7 in 2
      supers (kc + 1, cap + 1), one with 9 in 3 supers (ks + 1);
    phantoms: C 49 in supers of 16 (the last super holds cluster 48 and 15
      padding children), kc 16: rays from a point between clusters 47 and
      48 meet only 48 (16 candidates at levels 2, its phantoms alone, at
      exactly kc), rays from the line's start meet 44-48 (20: past kc for
      the phantoms only);
    small_c: C 20 < 32 in supers of 4, cap 24 > C, kc 24 > C, ks 6 > Cs;
      rays from inside the boxes' region (many candidates);
    pad_rule: C 40 in supers of 4, ks 2: a line through clusters 4, 13
      and 22 (supers 1, 3 and 5 of 10): over k_supers, its k_supers-th
      super (3) not the last one (9), so the pad is 3 * 4 + 3 = 15."""
    rng = np.random.default_rng([seed, 900 + RAY_CULL_CASES.index(name)])
    n, ss, ks, kc, cap, t_min = 128, 4, 6, 12, 8, T_MIN
    c = {"phantoms": 49, "small_c": 20, "pad_rule": 40}.get(name, 70)
    if name == "phantoms":
        ss, kc = 16, 16
    elif name in ("count_edges", "pad_rule"):
        ks, kc, cap = 2, 6, 6
    elif name == "small_c":
        ks, kc, cap = 6, 24, 24
    bmin, bmax = _random_boxes(rng, c)
    o = rng.uniform(-1.2, 1.2, (n, 3))
    d = _unit(rng.standard_normal((n, 3)))
    tm = rng.uniform(0.5, 4.0, n)
    lines = {"count_edges": [(list(range(0, 8)), 6), (list(range(8, 16)), 7),
                             (list(range(16, 28)), 9)],
             "phantoms": [([44, 45, 46, 47, 48], 5)],
             "pad_rule": [([4, 13, 22], 3)]}.get(name, [])
    if lines:
        # the random boxes move far from the lines (y, z about -30)
        bmin += (0.0, -30.0, -30.0)
        bmax += (0.0, -30.0, -30.0)
        per = n // len(lines)
        for k, (ids, n_on) in enumerate(lines):
            _place_line(bmin, bmax, ids, k, n_on)
            part = slice(k * per, (k + 1) * per)
            o[part], d[part], tm[part] = _line_rays(rng, k, n_on, per)
        if name == "phantoms":
            # the second half starts between clusters 47 (t 4) and 48 (t 5)
            o[n // 2:] += 4.5 * _unit(np.asarray(WL_LINE_D))
    elif name == "t_max_values":
        t_min = 0.0
        for i, v in enumerate((-1.0, -0.0, 0.0, np.nan, np.inf)):
            tm[i::6] = v
        box = rng.integers(0, c, n // 4)
        o[::4] = (bmin[box] + bmax[box]) / 2
    elif name in ("axis_on_plane", "signed_zero"):
        axis = rng.integers(0, 3, n)
        other = (axis + rng.integers(1, 3, n)) % 3
        if name == "axis_on_plane":
            d = np.zeros((n, 3))
            d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
        else:
            zero = rng.choice([-0.0, 0.0], n)
            d[np.arange(n), other] = zero
            # half the rays: a second zero, of the other sign
            two = np.nonzero(rng.uniform(size=n) < 0.5)[0]
            d[two, 3 - axis[two] - other[two]] = np.where(
                np.signbit(zero[two]), 0.0, -0.0)
        box = rng.integers(0, c, n)
        # the origin on a plane of the box on an axis the ray does not move
        plane = np.where(rng.uniform(size=n) < 0.5, bmin[box, other],
                         bmax[box, other])
        o[np.arange(n), other] = plane
        # and aimed near the box on the moving axis
        o[np.arange(n), axis] = ((bmin[box, axis] + bmax[box, axis]) / 2
                                 - 1.0 * np.sign(d[np.arange(n), axis]))
        tm = np.full(n, 8.0)
    elif name == "flat_boxes":
        fa = rng.integers(0, 3, c)
        bmax[np.arange(c), fa] = bmin[np.arange(c), fa]
        box = rng.integers(0, c, n)
        aim = (bmin[box] + bmax[box]) / 2
        d = _unit(aim - o)
        tm = np.full(n, 8.0)
    elif name == "small_c":
        bmin, bmax = _random_boxes(rng, c, half=(0.2, 0.6))
        o = rng.uniform(-0.5, 0.5, (n, 3))
        tm = np.where(np.arange(n) % 2, np.inf, 3.0)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return {"o": f(o), "d": f(d), "tm": f(tm), "t_min": t_min,
            "bmin": f(bmin), "bmax": f(bmax),
            **wl_supers(f(bmin), f(bmax), ss), "ss": ss, "ks": ks,
            "kc": kc, "cap": cap}


# The pair tables' crafted cases (accel.cuda_cull pair_tables and its plain
# version): name -> (ray_cull_case, cap, pair_budget, tile_rays,
# pair_align). Each is held at its cap and at cap + 1.
PAIR_CASES = {
    "t_max_values": ("t_max_values", 8, 8, 4, 1),
    "axis_on_plane": ("axis_on_plane", 8, 8, 4, 2),
    "signed_zero": ("signed_zero", 8, 8, 4, 1),
    "flat_boxes": ("flat_boxes", 8, 8, 16, 1),
    "count_edges": ("count_edges", 6, 8, 4, 1),
    "over_budget": ("count_edges", 7, 3, 4, 1),
    "small_c": ("small_c", 24, 8, 4, 1),
    "phantoms": ("phantoms", 16, 2, 8, 1),
    "pad_rule": ("pad_rule", 6, 8, 4, 1),
}


def pair_case(name: str, seed: int = 0) -> dict:
    """One pair-table input: the rays and boxes of its ray_cull_case with
    its cap, pair_budget, tile_rays (T) and pair_align:
    t_max_values, axis_on_plane, signed_zero, flat_boxes: the slab edges
      (dead, -0.0, +0.0, NaN and +inf t_max; 0 x inf in the slab; +-0.0
      directions; flat boxes), pair_align 2 on one;
    count_edges: cap 6, lines of 6 candidates (exactly cap) and 7 (cap +
      1, over cap) and 9;
    over_budget: count_edges at cap 7 and pair budget 3 (P 384) with the
      rays in a seeded random order: the 7-candidate line's pairs in
      cluster 10 pass P for the rays that come late, which are over budget
      between rays that are not;
    small_c: C 20 < cap 24 (dst padded from C to cap with P);
    phantoms: C 49, T 8, budget 2; pad_rule: C 40.
    Culled in row steps of 5 rays, a cluster's rays straddle the steps."""
    src, cap, budget, t, align = PAIR_CASES[name]
    case = dict(ray_cull_case(src, seed))
    if name == "over_budget":
        perm = np.random.default_rng([seed, 950]).permutation(
            case["o"].shape[0])
        for k in ("o", "d", "tm"):
            case[k] = np.ascontiguousarray(case[k][perm])
    case.update(cap=cap, pair_budget=budget, tile_rays=t, pair_align=align)
    return case


# ctiles' 2-level cull's crafted cases (accel.cuda_ctiles block_cull at
# levels 2 and its plain version): the ray_cull_case rays in blocks of
# `b`, at the case's cap and super_cap, one past each, and kc / ks.
CTILES2_CASES = RAY_CULL_CASES
CTILES2_BLOCKS = (8, 4)
# the cases whose blocks hold one line of rays each: cap = kc, super_cap
# = ks; the others' blocks hold random rays, whose union of supers passes
# ks: cap = C and super_cap = Cs, so that their children are tested
CTILES2_LINES = ("count_edges", "phantoms", "pad_rule")


def ctiles2_case(name: str, b: int = 8, seed: int = 0) -> dict:
    """One 2-level block-cull input: ray_cull_case(name)'s 128 rays in
    blocks of b (o_blk, d_blk [128 / b, b, 3], tm_blk [128 / b, b]; a
    line's rays are consecutive, so a block holds one line, or the two
    around a border), its boxes, supers and children (a partly filled last
    super's padding children inverted), cap = kc and super_cap = ks:
    count_edges: lines of 6 children in 2 supers (exactly cap 6 and
      super_cap 2), 7 in 2 (cap + 1) and 9 in 3 (super_cap + 1);
    phantoms: the last super holds cluster 48 and 15 padding children,
      which the children's sign-select rule fails;
    pad_rule: a super list past its cap;
    t_max_values, axis_on_plane, signed_zero, flat_boxes, small_c: the
      slab edges and C < 32 (these
    at cap C and super_cap Cs, so that every block's children are
    tested)."""
    case = dict(ray_cull_case(name, seed))
    n = case["o"].shape[0]
    lines = name in CTILES2_LINES
    case.update(o_blk=case["o"].reshape(n // b, b, 3),
                d_blk=case["d"].reshape(n // b, b, 3),
                tm_blk=case["tm"].reshape(n // b, b), b=b,
                cap=case["kc"] if lines else case["bmin"].shape[0],
                super_cap=case["ks"] if lines else case["sbmin"].shape[0])
    return case


# ---- the exact shadow cull (exact_case) ------------------------------------

EXACT_CASES = ("inf_entry", "super_edge", "dead_unsorted",
               "inverted_children", "axis_planes", "entry_ties",
               "whole_shortlist")


def _f32_interval_pass(bmin, bmax, o, d, tm) -> bool:
    """The interval cull's test (traverse._interval_slab) of a block whose
    live lanes are all the ray (o, d): the quotients by d in f32 (no
    component of d is 0)."""
    f = np.float32
    lb, ub = f(-np.inf), f(np.inf)
    for a in range(3):
        q = (f(f(bmin[a]) - f(o[a])) / f(d[a]),
             f(f(bmax[a]) - f(o[a])) / f(d[a]))
        lb, ub = max(lb, min(q)), min(ub, max(q))
    return bool(lb <= ub and ub >= 0.0 and lb <= tm)


def _f32_lane_pass(bmin, bmax, o, d, t_min, tm) -> bool:
    """The exact cull's per-lane test (the sign-select slab, products by
    the f32 reciprocal) of the ray (o, d) on [t_min, tm]."""
    f = np.float32
    lo, hi = f(t_min), f(tm)
    for a in range(3):
        iv = f(1.0) / f(d[a])
        near, far = (bmin[a], bmax[a]) if iv >= 0 else (bmax[a], bmin[a])
        lo = max(lo, f(f(near) - f(o[a])) * iv)
        hi = min(hi, f(f(far) - f(o[a])) * iv)
    return bool(lo <= hi)


def _grazing_ray(rng, bmin, bmax, tm, t_min):
    """A ray that grazes the box's edge (x = bmax.x, y = bmin.y) going +x
    +y, whose own slab test passes where the interval test of a block of
    it alone fails: the quotient and the product by the reciprocal round
    the touch time apart. Seeded search."""
    f = np.float32
    for _ in range(20000):
        zm = rng.uniform(bmin[2], bmax[2])
        p = np.array([bmax[0], bmin[1], zm])
        d = _unit(np.array([rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0),
                            rng.uniform(-0.01, 0.01)])).astype(np.float32)
        o = (p - rng.uniform(1.0, 3.0) * d).astype(np.float32)
        if (_f32_lane_pass(bmin, bmax, o, d, t_min, tm)
                and not _f32_interval_pass(bmin, bmax, o, d, tm)):
            return o, d
    raise AssertionError("no grazing ray found")


def exact_case(name: str, seed: int = 0) -> dict:
    """One exact-cull input: o_blk, d_blk [nb, b, 3], tm_blk [nb, b] (t_max;
    negative or NaN: dead), t_min, the cluster boxes bmin, bmax [C, 3] and
    their supers of `ss` (wl_supers: a partly filled last super's padding
    children inverted), all f32, and the case's ksup (held at it and one
    past it). C 70 in supers of 4 (not a multiple) unless said otherwise:
    inf_entry: C 40; cluster 7 (super 1, child 3) grazed at an edge by a
      ray (_grazing_ray) whose own test passes where its block's interval
      test fails, and cluster 2 (super 0) on its path: an exact id of
      conservative entry +inf, which sorts among the sentinels by its slot
      (7) and lands past n_cand (2). Blocks: the ray on lane 0 alone, on
      every lane, and on lane 3 among dead lanes at the placeholder ray
      (o 0, d +x); then coherent blocks far from it. ksup 3;
    super_edge: lines of 12 clusters in 3 supers and 16 in 4 (_line_boxes)
      at ksup 3: blocks at n_sup = ksup and ksup + 1 (the conservative
      list);
    dead_unsorted: coherent blocks with all-dead blocks first, between and
      last (unsorted), a block of NaN t_max lanes with one live lane (the
      interval cull's max t_max is NaN: its exact id has entry +inf), dead
      lanes at NaN origins; blocks at n_sup = ksup and ksup + 1. ksup 8;
    inverted_children: C 49 in supers of 16 (cluster 48 and 15 inverted
      padding children in the last), a line through clusters 44-48: the
      children of supers 2 and 3 listed, the padding ones failed. ksup 2;
    axis_planes: d = +-e_a with +0.0 / -0.0 in the other components (every
      third block only -0.0), the origin on a plane of a block's box on an
      axis the ray does not move (0 x inf = NaN in the slab, guarded),
      t_max just past the box. ksup 8;
    entry_ties: boxes repeated at scattered ids (equal entries), nested
      boxes around a point that half the blocks start at (entries 0), and
      boxes with a face on x = 0.5 that rays from x = 0.5 going -x enter at
      lb -0.0. ksup 15;
    whole_shortlist: boxes of half 0.2-0.6, rays from inside their region:
      ksup 18 = Cs, kchild 72 >= C (the row cut to C)."""
    rng = np.random.default_rng([seed, 1100 + EXACT_CASES.index(name)])
    nb, b, ss, c, t_min = 8, 8, 4, 70, T_MIN
    ksup = {"inf_entry": 3, "super_edge": 3, "dead_unsorted": 8,
            "inverted_children": 2, "axis_planes": 8, "entry_ties": 15,
            "whole_shortlist": 18}[name]
    if name == "inf_entry":
        c = 40
    elif name == "inverted_children":
        c, ss = 49, 16
    elif name == "dead_unsorted":
        nb = 12
    half = (0.2, 0.6) if name == "whole_shortlist" else (0.02, 0.2)
    bmin, bmax = _random_boxes(rng, c, half=half)
    o, d, tm = _coherent_rays(rng, nb, b)

    if name == "inf_entry":
        bmin += (0.0, -30.0, -30.0)
        bmax += (0.0, -30.0, -30.0)
        g = _random_boxes(rng, 1, half=(0.1, 0.3))
        go, gd = _grazing_ray(rng, g[0][0], g[1][0], 8.0, t_min)
        bmin[7], bmax[7] = g[0][0], g[1][0]
        centre = go + 4.0 * gd  # cluster 2, on the path
        bmin[2], bmax[2] = centre - 0.2, centre + 0.2
        # the others of supers 0 and 1: off the path, super 1 reaching past
        # the grazed edge in x and y so that the ray crosses it properly
        for k, shift in ((0, 3.0), (1, 5.0), (3, 7.0)):
            bmin[k], bmax[k] = bmin[2] + (0, 0, shift), bmax[2] + (0, 0, shift)
        for k, shift in ((4, (0.5, -0.5, 3.0)), (5, (0, 0, 5.0)),
                         (6, (0, 0, 7.0))):
            bmin[k], bmax[k] = bmin[7] + shift, bmax[7] + shift
        o[:3], d[:3], tm[:3] = go, gd, 8.0
        tm[0, 1:] = -1.0
        tm[2, :] = -1.0
        tm[2, 3] = 8.0
        o[2, np.arange(b) != 3] = 0.0
        d[2, np.arange(b) != 3] = (1.0, 0.0, 0.0)
        o[3:] += (0.0, -30.0, -30.0)
    elif name == "super_edge":
        bmin[28:] += (0.0, -30.0, -30.0)
        bmax[28:] += (0.0, -30.0, -30.0)
        for k, (ids, n_on) in enumerate(((list(range(12)), 12),
                                         (list(range(12, 28)), 16))):
            _place_line(bmin, bmax, ids, k, n_on)
        for i in range(nb):
            n_on = (12, 16)[i % 2]
            o[i], d[i], tm[i] = _line_rays(rng, i % 2, n_on, b)
    elif name == "dead_unsorted":
        for i in (0, 1, 5, nb - 1):
            tm[i] = -1.0
        tm[3] = np.nan
        tm[3, 4] = 2.0
        tm[4, ::2] = -1.0
        o[4, ::2] = np.nan
    elif name == "inverted_children":
        bmin[:44] += (0.0, -30.0, -30.0)
        bmax[:44] += (0.0, -30.0, -30.0)
        _place_line(bmin, bmax, [44, 45, 46, 47, 48], 0, 5)
        for i in range(nb):
            o[i], d[i], tm[i] = _line_rays(rng, 0, 5, b)
    elif name == "axis_planes":
        axis = rng.integers(0, 3, nb)
        sign = rng.choice([-1.0, 1.0], nb)
        for i in range(nb):
            a = axis[i]
            zeros = np.where(rng.uniform(size=(b, 3)) < 0.5, -0.0, 0.0)
            if i % 3 == 0:
                zeros[:] = -0.0
            d[i] = zeros
            d[i, :, a] = sign[i]
            box = np.full(b, rng.integers(0, c))
            other = (a + rng.integers(1, 3, b)) % 3
            third = 3 - a - other
            lanes = np.arange(b)
            o[i, lanes, other] = np.where(rng.uniform(size=b) < 0.5,
                                          bmin[box, other], bmax[box, other])
            o[i, lanes, third] = (bmin[box, third] + bmax[box, third]) / 2
            o[i, lanes, a] = (bmin[box, a] + bmax[box, a]) / 2 - sign[i]
        tm = np.where(tm >= 0.0, 1.5, tm)
    elif name == "entry_ties":
        pick = rng.integers(0, c // 3, c)
        bmin, bmax = bmin[pick], bmax[pick]
        q = np.array([0.2, -0.1, 0.3])
        nested = rng.choice(c, 8, replace=False)
        bmin[nested] = q - 0.05 * np.arange(1, 9)[:, None]
        bmax[nested] = q + 0.05 * np.arange(1, 9)[:, None]
        face = rng.choice(np.setdiff1d(np.arange(c), nested), 6,
                          replace=False)
        bmin[face] = (0.0, -3.0, -3.0)
        bmax[face] = (0.5, 3.0, 3.0)
        o[::2] = q + rng.normal(0.0, 1e-3, (nb // 2, b, 3))
        o[1::4, :, 0] = 0.5
        d[1::4] = np.stack([-rng.uniform(0.5, 1.0, (len(d[1::4]), b)),
                            rng.uniform(-0.5, 0.5, (len(d[1::4]), b)),
                            rng.uniform(-0.5, 0.5, (len(d[1::4]), b))], -1)
    elif name == "whole_shortlist":
        o = rng.uniform(-0.5, 0.5, (nb, b, 3))
        tm = np.where(tm >= 0.0, 3.0, tm)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    bmin, bmax = f(bmin), f(bmax)
    return {"o_blk": f(o), "d_blk": f(d), "tm_blk": f(tm), "t_min": t_min,
            "bmin": bmin, "bmax": bmax, **wl_supers(bmin, bmax, ss),
            "ss": ss, "ksup": ksup}


# perray's entry order (perray_entry): the per-ray cull cases at these caps
# (the case's, one past it, and 1: a top-1 selection)
def perray_entry_caps(case: dict) -> tuple:
    return (case["cap"], case["cap"] + 1, 1)
