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
first-slot closest (see cascade_case for each case).
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
