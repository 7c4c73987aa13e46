"""ctiles' dynamic bounds on the device: the port's block cull, its
static-size pair build, its slot sweep and its compaction index against
the JAX package's functions, on the CPU.

- block_cull's plain version (which accel.cuda_ctiles.block_cull takes on
  CPU tensors) against JAX's `_ray_masks` + `_extract_order_flat` under jax.jit with
  the live-block count as a traced value: no live block, one, exactly a
  row-chunk border, every block, and no bound (sort=False); order over
  n_cand, n_cand and over exact.
- `_build_pairs` (static slot tables) against JAX's at tile_group=1:
  n_slots equal, the slot tables equal over the live prefix.
- `_sweep_resolve` (slot_sweep's plain version, folded per block) and
  `pairs._sweep_tiles` (per slot) against JAX's (use_pallas=False).
- the whole closest_hit_ctiles / any_hit_ctiles, with overflow, and on
  exact geometry (tests/test_torch_sweep_cases.py exact_clusters): t ties
  across clusters, a hit at exactly t_min, -0.0 against +0.0.
- pairs.overflow_index against jnp.nonzero(size=k, fill_value=n).

hit, tri, occlusion and the tables exact; t within rtol 1e-6 plus atol
2e-6 (XLA's CPU code contracts FMAs, eager torch does not; ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_ai_tpu.accel import ctiles as jctiles
from path_tracer_ai_tpu.accel import pairs as jpairs
from path_tracer_ai_tpu.accel import worklist as jworklist
from path_tracer_ai_tpu.accel.clusters import build_clusters as jbuild
from path_tracer_ai_tpu.core.types import triangles_from_numpy as jtriangles
from path_tracer_ai_tpu_torch.accel import ctiles, cuda_ctiles, pairs, worklist
from path_tracer_ai_tpu_torch.convert import accel_from_numpy
from path_tracer_ai_tpu_torch.core.types import triangles_from_numpy
from path_tracer_ai_tpu_torch.engine import intersect
import test_torch_sweep_cases as cases  # tests/, numpy only
from tests.test_torch_worklist import (  # noqa: F401
    T,
    T_TOL,
    _one_torch_thread,
    _rays,
    _scene,
)

ROW_CHUNK = 8


def _blocks(rng, ja, pa, n, n_live, sort=True, block=8):
    """The same sorted ray blocks from both packages; rays past n_live
    dead (sorted last)."""
    o, d, tm = _rays(rng, n, dead_every=0)
    tm[n_live:] = -1.0
    rng.shuffle(tm)
    jb = jworklist._prepare_blocks(ja, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), block, sort, "octorig")
    pb = worklist._prepare_blocks(pa, T(o), T(d), T(tm), block, sort,
                                  "octorig")
    return jb, pb, tm


@jax.jit
def _jax_cull(ja, o_blk, d_blk, tm_blk, live_blocks):
    cand, n_cand = jctiles._ray_masks(ja, o_blk, d_blk, tm_blk, 1e-3,
                                      ROW_CHUNK, live_blocks=live_blocks)
    return jctiles._extract_order_flat(ja, cand, n_cand, 48,
                                       live_blocks=live_blocks,
                                       row_chunk=ROW_CHUNK)


def _jax_cull_static(ja, o_blk, d_blk, tm_blk, cap):
    cand, n_cand = jctiles._ray_masks(ja, o_blk, d_blk, tm_blk, 1e-3,
                                      ROW_CHUNK)
    return jctiles._extract_order_flat(ja, cand, n_cand, cap)


def _same_tables(got, want):
    order, n_cand, over = (x.numpy() for x in got)
    j_order, j_n, j_over = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(n_cand, j_n)
    np.testing.assert_array_equal(over, j_over)
    k = np.arange(order.shape[1])[None, :] < n_cand[:, None]
    np.testing.assert_array_equal(np.where(k, order, -1),
                                  np.where(k, j_order, -1))


# live rays of 256 (blocks of 8: 32 blocks, 4 row chunks of 8)
@pytest.mark.parametrize("n_live", [0, 5, 64, 256])
def test_block_cull_plain_matches_jax_traced_bound(rng, n_live):
    """No live block, one, exactly a row-chunk border (8 blocks), all."""
    ja, pa, _ = _scene(rng, 500, 16)
    jb, pb, tm = _blocks(rng, ja, pa, 256, n_live)
    lb = -(-int((tm >= 0).sum()) // 8)
    assert lb == -(-n_live // 8)
    bound = torch.tensor([lb], dtype=torch.int32)
    got = cuda_ctiles.block_cull_plain(pa, *pb[:3], 1e-3, 48, bound,
                                       row_chunk=ROW_CHUNK)
    want = _jax_cull(ja, *jb[:3], jnp.int32(lb))
    _same_tables(got, want)
    assert int(got[1][lb:].sum()) == 0 and not bool(got[2][lb:].any())
    # the wrapper on CPU tensors: the plain version, in its own chunks
    for g, w in zip(cuda_ctiles.block_cull(pa, *pb[:3], 1e-3, 48, bound),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lb", [0, 1, 9])
def test_block_cull_plain_empties_blocks_past_the_bound(rng, lb):
    """Blocks at or past live_blocks get the empty set (n_cand 0, not over,
    C - 1 everywhere) whatever their rays, as the kernel writes; the blocks
    before it are the unbounded cull's."""
    _ja, pa, _ = _scene(rng, 500, 16)
    o, d, tm = _rays(rng, 256, dead_every=0)
    o_blk, d_blk, tm_blk = (x.reshape(32, 8, -1).squeeze(-1)
                            for x in (T(o), T(d), T(tm)))
    bound = torch.tensor([lb], dtype=torch.int32)
    order, n_cand, over = cuda_ctiles.block_cull_plain(
        pa, o_blk, d_blk, tm_blk, 1e-3, 48, bound, row_chunk=ROW_CHUNK)
    full = cuda_ctiles.block_cull_plain(pa, o_blk, d_blk, tm_blk, 1e-3, 48,
                                        None, row_chunk=ROW_CHUNK)
    assert int(full[1][lb:].sum()) > 0
    assert torch.equal(n_cand[:lb], full[1][:lb])
    assert torch.equal(order[:lb], full[0][:lb])
    assert int(n_cand[lb:].sum()) == 0 and not bool(over[lb:].any())
    assert bool((order[lb:] == pa.num_clusters - 1).all())


@pytest.mark.parametrize("cap", [1, 4, 48])
def test_block_cull_plain_matches_jax_unsorted(rng, cap):
    """sort=False (no live-block bound, every block culled); cap 1 and 4
    overflow most blocks (JAX's peel path below 32), 48 few."""
    ja, pa, _ = _scene(rng, 500, 16)
    jb, pb, _tm = _blocks(rng, ja, pa, 192, 150, sort=False)
    got = cuda_ctiles.block_cull_plain(pa, *pb[:3], 1e-3, cap, None,
                                       row_chunk=ROW_CHUNK)
    _same_tables(got, _jax_cull_static(ja, *jb[:3], cap))
    if cap == 1:
        assert bool(got[2].all() | (got[1] <= 1).all())
        assert bool(got[2].any())


@pytest.mark.parametrize("split", [0, 2])
def test_build_pairs_static_tables_match_jax(rng, split):
    """n_slots and n_tiles on the device; the slot tables of the static
    size (at least n_pairs + tile_blocks * C) equal to JAX's (tile_group 1)
    over the live prefix."""
    ja, pa, _ = _scene(rng, 500, 16)
    _jb, pb, _tm = _blocks(rng, ja, pa, 256, 200)
    order, n_cand, over = cuda_ctiles.block_cull_plain(
        pa, *pb[:3], 1e-3, 16, None, row_chunk=ROW_CHUNK)
    tb, tc = 4, 2
    got = ctiles._build_pairs(pa, order, n_cand, over, 16, tb,
                              split_head=split)
    want = jctiles._build_pairs(ja, jnp.asarray(order.numpy()),
                                jnp.asarray(n_cand.numpy()),
                                jnp.asarray(over.numpy()), 16, tb, tc,
                                tile_group=1, split_head=split)
    n_slots = int(want["n_slots"])
    assert got["n_slots"].dim() == 0 and int(got["n_slots"]) == n_slots > 0
    assert int(got["n_tiles"]) == n_slots // tb
    assert got["n_tiles"].dtype == torch.int32
    c = pa.num_clusters
    n_pairs = 32 * 16 if not split else 32 * split + 4 * (16 - split)
    assert got["slot_pair"].shape[0] >= n_pairs + tb * c
    assert got["slot_pair"].shape[0] % tb == 0
    np.testing.assert_array_equal(got["slot_cid"].numpy()[:n_slots],
                                  np.asarray(want["slot_cid"])[:n_slots])
    np.testing.assert_array_equal(got["slot_pair"].numpy()[:n_slots],
                                  np.asarray(want["slot_pair"])[:n_slots])
    np.testing.assert_array_equal(got["overflow"].numpy(),
                                  np.asarray(want["overflow"]))
    assert (got["slot_pair"].numpy()[n_slots:] == -1).all()


@pytest.mark.parametrize("want_tri", [True, False])
@pytest.mark.parametrize("tile_chunk", [1, 3])
def test_sweep_resolve_plain_matches_jax(rng, want_tri, tile_chunk):
    """The slot sweep folded per block (closest: least t, then the least
    tri at it; any hit: OR) against JAX's chunked fori_loop sweep."""
    ja, pa, _ = _scene(rng, 500, 16)
    jb, pb, _tm = _blocks(rng, ja, pa, 256, 220)
    cap, tb = 16, 4
    order, n_cand, over = cuda_ctiles.block_cull_plain(
        pa, *pb[:3], 1e-3, cap, None, row_chunk=ROW_CHUNK)
    tabs = ctiles._build_pairs(pa, order, n_cand, over, cap, tb)
    got = ctiles._sweep_resolve(pa, tabs, *pb[:3], 1e-3, cap, tb,
                                tile_chunk, want_tri,
                                cuda_ctiles.pack_tris(pa))
    jtabs = jctiles._build_pairs(ja, jnp.asarray(order.numpy()),
                                 jnp.asarray(n_cand.numpy()),
                                 jnp.asarray(over.numpy()), cap, tb,
                                 tile_chunk)
    want = jctiles._sweep_resolve(ja, jtabs, *jb[:3], 1e-3, cap, tb,
                                  tile_chunk, want_tri)
    if not want_tri:
        assert 0.05 < np.asarray(want[0]).mean() < 0.95
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        return
    t_j, tri_j = (np.asarray(x) for x in want)
    assert np.isfinite(t_j).mean() > 0.02
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()),
                                  np.isfinite(t_j))
    np.testing.assert_array_equal(got[1].numpy(), tri_j)
    np.testing.assert_allclose(got[0].numpy(), t_j, **T_TOL)


@pytest.mark.parametrize("want_tri", [True, False])
def test_pairs_sweep_tiles_match_jax(rng, want_tri):
    """pairs._sweep_tiles (slot_sweep per slot lane, the tile count on the
    device) against JAX's over every pair slot of the static budget."""
    ja, pa, _ = _scene(rng, 400, 16)
    o, d, tm = _rays(rng, 200, t_max=(0.3, 12.0), dead_every=5)
    kw = dict(cap=8, tile_rays=16)
    tt = pairs.build_pair_tables(pa, T(o), T(d), 1e-3, T(tm), **kw)
    tj = jpairs.build_pair_tables(ja, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                  jnp.asarray(tm), **kw)
    assert int(tt.n_tiles) == int(tj.n_tiles) > 1
    got = pairs._sweep_tiles(pa, tt, T(o), T(d), 1e-3, T(tm), 16, want_tri)
    want = jpairs._sweep_tiles(ja, tj, jnp.asarray(o), jnp.asarray(d), 1e-3,
                               jnp.asarray(tm), 16, 4, want_tri)
    if not want_tri:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.asarray(want[0]).any()
        return
    t_j, tri_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), tri_j)
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()),
                                  np.isfinite(t_j))
    np.testing.assert_allclose(got[0].numpy(), t_j, **T_TOL)


def _check_queries(ja, pa, ptris, o, d, t_min, tm, kw, min_hit=0.05):
    args_j = (ja, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(tm))
    args_t = (pa, T(o), T(d), t_min, T(tm))
    hj = jctiles.closest_hit_ctiles(*args_j, **kw)
    ht = ctiles.closest_hit_ctiles(*args_t, **kw)
    assert np.asarray(hj.hit).mean() > min_hit
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), **T_TOL)
    bf = intersect.closest_hit(ptris, *args_t[1:])
    hit = bf.hit.numpy()
    np.testing.assert_array_equal(ht.hit.numpy(), hit)
    np.testing.assert_array_equal(ht.tri.numpy()[hit], bf.tri.numpy()[hit])
    occ_j = np.asarray(jctiles.any_hit_ctiles(*args_j, **kw))
    occ_t = ctiles.any_hit_ctiles(*args_t, **kw)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    return ht


@pytest.mark.parametrize("name,kw", [
    ("plain", dict(tile_chunk=2, row_chunk=8)),
    ("overflow", dict(cap=2, tile_chunk=2, row_chunk=8)),
    ("unsorted", dict(sort=False, tile_chunk=3)),
])
def test_ctiles_queries_match_jax(rng, name, kw):
    """closest_hit_ctiles / any_hit_ctiles whole: the block cull, the
    static tables, the slot sweep and (cap 2) the overflow fallback."""
    ja, pa, ptris = _scene(rng, 500, 16)
    o, d, tm = _rays(rng, 256)
    _check_queries(ja, pa, ptris, o, d, 1e-3, tm, kw)


def _exact_scene(s=16):
    """The exact clusters 1, 0 and 2 as a soup (cluster 1's triangles, the
    ones wound the other way, first: the smaller ids)."""
    geo = {k: cases.exact_clusters(s)[k][[1, 0, 2]] for k in ("v0", "e1",
                                                             "e2")}
    v0 = geo["v0"].reshape(-1, 3)
    t = v0.shape[0]
    n = np.tile([[0, 0, 1]], (t, 1)).astype(np.float32)
    uv = np.zeros((t, 2), np.float32)
    tris = jtriangles(v0, v0 + geo["e1"].reshape(-1, 3),
                      v0 + geo["e2"].reshape(-1, 3), n, n, n, uv, uv, uv,
                      np.zeros(t, np.int32))
    ja = jbuild(tris, cluster_size=s, super_size=4)
    pa = accel_from_numpy(*(np.asarray(a) for a in ja), device="cpu")
    ptris = triangles_from_numpy(*(np.asarray(a) for a in tris),
                                 device="cpu")
    return ja, pa, ptris


@pytest.mark.parametrize("name", ["ties", "t_min_hit", "signed_zero"])
def test_ctiles_queries_on_exact_geometry(name):
    """Rays along +z through the exact clusters: t = 2 at two copies of
    the same triangles (the smaller ids win), a hit at exactly t_min = 2,
    and from their plane with t_min 0: -0.0 (the larger ids) against +0.0
    (the smaller), one t, +0.0 out."""
    ja, pa, ptris = _exact_scene()
    case = cases.slot_case(name, 16, 16, 8)
    rays = case["rays"][:-1]                           # [rows, 8, b]
    o = np.ascontiguousarray(rays[:, 0:3].transpose(0, 2, 1).reshape(-1, 3))
    d = np.ascontiguousarray(rays[:, 3:6].transpose(0, 2, 1).reshape(-1, 3))
    tm = np.ascontiguousarray(rays[:, 6].reshape(-1))
    ht = _check_queries(ja, pa, ptris, o, d, case["t_min"], tm,
                        dict(tile_chunk=1, row_chunk=2), min_hit=0.9)
    t = ht.t.numpy()
    if name == "signed_zero":
        assert (t == 0.0).all() and not np.signbit(t).any()
    else:
        assert (t == 2.0).all()
    assert (ht.tri.numpy() < 16).all()  # the smaller ids of the two


@pytest.mark.parametrize("name", cases.SLOT_CASES)
@pytest.mark.parametrize("shape", cases.SLOT_SHAPES)
def test_slot_sweep_plain_on_crafted_cases(name, shape):
    """slot_sweep's plain version on the crafted slot tables: the per-row
    fold against a brute force over each row's own candidates (least t,
    then least id; -0.0 as +0.0), the any-hit fold against its hits, and
    the per-slot lanes against tile_sweep on the live tiles (inf and
    INT32_MAX past them)."""
    tb, b = shape
    case = cases.slot_case(name, 16, tb, b)
    pack = T(cases.pack(case))
    args = (pack, T(case["rays"]), T(case["slot_ref"]), T(case["slot_cid"]),
            torch.tensor([case["n_tiles"]], dtype=torch.int32))
    kw = dict(tile_slots=tb, cap=case["cap"], cid_stride=tb)
    sweep = cuda_ctiles.slot_sweep_plain
    t, tri = sweep(*args, out="closest", tile_chunk=1, **kw)
    (occ,) = sweep(*args, out="any", tile_chunk=1, **kw)
    t_s, tri_s = sweep(*args, out="slot", tile_chunk=1, **kw)
    # the wrapper on CPU tensors: the plain version, in its own chunks
    got = cuda_ctiles.slot_sweep(*args, out="closest", **kw)
    assert torch.equal(got[0], t) and torch.equal(got[1], tri)
    rows = case["rays"].shape[0] - 1
    ref = case["slot_ref"][:case["n_tiles"] * tb]
    want_t = np.full((rows, b), np.inf, np.float32)
    want_tri = np.full((rows, b), 2**31 - 1, np.int64)
    lanes = T(case["rays"])
    for row in range(rows):
        cids = sorted({int(case["slot_cid"][i]) for i in range(len(ref))
                       if ref[i] >= 0 and ref[i] // case["cap"] == row})
        if not cids:
            continue
        rp = lanes[row:row + 1]                         # [1, 8, b]
        for cid in cids:
            ct, ctri = cuda_ctiles.tile_sweep_plain(
                pack, rp, torch.tensor([cid], dtype=torch.int32))
            ct, ctri = ct[0].numpy(), ctri[0].numpy()
            better = (ct < want_t[row]) | ((ct == want_t[row])
                                           & (ctri < want_tri[row]))
            want_t[row] = np.where(better, ct, want_t[row])
            want_tri[row] = np.where(better, ctri, want_tri[row])
    want_t = np.where(want_t == 0.0, np.float32(0.0), want_t)
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  want_t.view(np.int32))
    np.testing.assert_array_equal(tri.numpy(), want_tri)
    np.testing.assert_array_equal(occ.numpy(), want_tri < 2**31 - 1)
    live = case["n_tiles"] * tb * b
    assert (t_s.numpy()[live:] == np.inf).all()
    assert (tri_s.numpy()[live:] == 2**31 - 1).all()
    if name == "no_tiles":
        assert not occ.numpy().any()
    elif name == "signed_zero":
        assert (t.numpy() == 0.0).all() and not np.signbit(t.numpy()).any()


@pytest.mark.parametrize("n,k,n_set", [(64, 8, 0), (64, 8, 5), (64, 8, 8),
                                       (300, 32, 31), (7, 8, 7)])
def test_overflow_index_matches_nonzero(rng, n, k, n_set):
    """The compacted fallback's index list: jnp.nonzero(size=k,
    fill_value=n), with no host read."""
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_set, replace=False)] = True
    got = pairs.overflow_index(T(mask), k).numpy()
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=k,
                                  fill_value=n)[0])
    np.testing.assert_array_equal(got, want)
