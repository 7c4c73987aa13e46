"""The cascade stage kernel's split of a slot over W warps, and the rule
that picks W, on the CPU.

The kernel (csrc/ctiles_sweep.cu, cascade_stage_kernel) cuts a 32-lane
slot's group, its g clusters in chunks of 32 triangles (g ceil(S / 32)
chunks in slot order), into W contiguous ranges, one a warp. Each warp
folds its range from the slot's carry as the whole sweep does; the team
then combines the ranges in order: any hit by OR, first slot by taking
range p's (t, id) only where t < the best of ranges 0 .. p - 1, and writes
where that t < the running best. It also sweeps only the blocks still on
its list. `split_sweep` and `split_stage` below emulate that in plain
torch (they are on no path of the package) and are held bit for bit
against the plain versions: cuda_ctiles.tile_sweep_plain (one group's
sweep) and cuda_cascade.cascade_stage_plain (whole cascades through
traverse._cascade_stages), at W = 1, 2, 4, 8, on the crafted cascades of
tests/test_torch_sweep_cases.py (CASCADE_CASES) and on its split cases
(SPLIT_CASES: exact ties in two ranges, -0.0 against +0.0 at equal t, NaN
t_max, dead lanes). The W rule, cuda_cascade.split_warps, is a pure
function of the stage's size, its lanes, the resident warps and the SMs.
"""

from functools import partial

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles, traverse
import test_torch_sweep_cases as cases  # tests/, numpy only

CHUNK = 32  # triangles a chunk (csrc/mt.cuh CHUNK)
I32_MAX = 2**31 - 1
SPLITS = (1, 2, 4, 8)
S_SIZES = (16, 128)  # one chunk a cluster (the generic instance's S), four
T_LANES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranges(g: int, s: int, w: int) -> list:
    """The kernel's cut of a group of g clusters of s triangles over w
    warps: for each warp, its pieces [cluster slot i, first triangle,
    end triangle] in order. Chunk c is triangles 32 (c % cpc) on of
    cluster c // cpc (cpc = ceil(s / 32)); warp p takes chunks
    [p n // w, (p + 1) n // w) of the n = g cpc."""
    cpc = -(-s // CHUNK)
    n = g * cpc
    out = []
    for p in range(w):
        pieces = []
        for c in range(p * n // w, (p + 1) * n // w):
            i, j0 = c // cpc, (c % cpc) * CHUNK
            if pieces and pieces[-1][0] == i and pieces[-1][2] == j0:
                pieces[-1][2] = min(j0 + CHUNK, s)
            else:
                pieces.append([i, j0, min(j0 + CHUNK, s)])
        out.append(pieces)
    return out


def split_sweep(pack, rays, cid, w, first, best=None):
    """One group's sweep as the kernel runs it at W = w: each warp's range
    piece by piece (tile_sweep_plain on the piece's triangles), folded in
    order from the carry (any hit: OR; first slot: a piece replaces the
    running (t, id) only where t < it), then the ranges combined in order
    the same way. first: best = (best t, best id), the carry; the rays'
    t_max is the cap. Returns occ [n, T] (any hit) or (t, id)."""
    parts = []
    for pieces in ranges(cid.shape[1], pack.shape[2], w):
        acc = (best if first
               else torch.zeros(rays.shape[::2], dtype=torch.bool))
        for i, j0, j1 in pieces:
            t, tri = cuda_ctiles.tile_sweep_plain(
                pack[:, :, j0:j1].contiguous(), rays,
                cid[:, i:i + 1].contiguous(),
                **({"tie": "slot"} if first else {}))
            if first:
                closer = t < acc[0]
                acc = (torch.where(closer, t, acc[0]),
                       torch.where(closer, tri, acc[1]))
            else:
                acc = acc | (tri != I32_MAX)
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        if first:
            closer = part[0] < out[0]
            out = (torch.where(closer, part[0], out[0]),
                   torch.where(closer, part[1], out[1]))
        else:
            out = out | part
    return out


def split_stage(pack, rays, order_g, n_cand, carry, k, threshold,
                entry=None, w=1):
    """cascade_stage's function as the kernel computes it: a vote on k
    that also lists the blocks to sweep (any hit: the active ones; first
    slot: those with k g < n_cand), then, while more than `threshold`
    blocks are active, a sweep of the listed blocks' group k cut as
    split_sweep cuts it, and a vote on k + 1."""
    _size, kgroups, g = order_g.shape
    last = kgroups - 1
    tb = rays[:, 6]
    kv = int(k)

    def vote():
        voting = kv * g < n_cand
        if entry is None:
            on = voting & ~(carry[0] | (tb < 0.0)).all(dim=1)
            return on, torch.nonzero(on).squeeze(1)
        best_eff = torch.where(tb < 0.0, -np.inf, carry[0])
        on = voting & (entry[:, min(kv, last) * g] <= best_eff.amax(dim=1))
        return on, torch.nonzero(voting).squeeze(1)

    act, listed = vote()
    while int(act.sum()) > threshold:
        cid = order_g[listed, min(kv, last)]
        r = rays[listed]
        if entry is None:
            (occ,) = carry
            r[:, 6].masked_fill_(occ[listed], -1.0)
            occ[listed] |= split_sweep(pack, r, cid, w, False)
        else:
            best_t, best_id = carry
            bt = best_t[listed]
            r[:, 6] = torch.minimum(r[:, 6], bt)
            t, tid = split_sweep(pack, r, cid, w, True,
                                 (bt, best_id[listed]))
            best_t[listed], best_id[listed] = t, tid
        kv += 1
        act, listed = vote()
    k.fill_(kv)
    return carry, k, act


def _cascade(stage, case, closest):
    """The case's whole cascade through traverse._cascade_stages: (carry,
    block order, final k)."""
    t = torch.as_tensor
    pack = t(cases.pack(case))
    nb, t_lanes = case["tm"].shape
    blocks = (t(case["rays"]), t(case["order_g"]), t(case["n_cand"]))
    if closest:
        blocks += (t(case["entry"]),)
        carry = (torch.full((nb, t_lanes), np.inf),
                 torch.full((nb, t_lanes), -1, dtype=torch.int32))
    else:
        carry = (torch.zeros((nb, t_lanes), dtype=torch.bool),)
    ks = []

    def run(b, c, k, thr):
        out = stage(pack, b[0], b[1], b[2], c, k, thr,
                    **({"entry": b[3]} if closest else {}))
        ks.append(int(out[1]))
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, run)
    return carry, blk, ks[-1]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want):
    for x, y in zip(got[0], want[0]):
        assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]


def _assert_split_stages(case, closest):
    want = _cascade(cuda_cascade.cascade_stage_plain, case, closest)
    for w in SPLITS:
        _assert_same(_cascade(partial(split_stage, w=w), case, closest),
                     want)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", [2, 5])
@pytest.mark.parametrize("s", S_SIZES)
@pytest.mark.parametrize("name", cases.CASCADE_CASES)
def test_split_stages_match_plain(name, s, g, closest):
    """Every crafted cascade, both folds, each W: the split stage gives
    cascade_stage_plain's carry bit for bit, its block order and its final
    k."""
    _assert_split_stages(cases.cascade_case(name, s, T_LANES, g), closest)


@pytest.mark.parametrize("closest", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("s", S_SIZES)
@pytest.mark.parametrize("name", cases.SPLIT_CASES)
def test_split_cases_match_plain(name, s, g, closest):
    """The split cases (ties in two ranges, -0.0 / +0.0, NaN t_max, dead
    lanes) through whole cascades, each W, against cascade_stage_plain."""
    _assert_split_stages(cases.split_case(name, s, 32, g), closest)


@pytest.mark.parametrize("s", S_SIZES)
@pytest.mark.parametrize("name", cases.SPLIT_CASES)
def test_split_sweep_matches_tile_sweep(name, s):
    """One group (g 2: cluster boundaries and, at S 128, chunk boundaries
    inside a cluster fall between ranges) of every split-case block, each
    W, against tile_sweep_plain: occlusion exact; first slot: t bit for bit
    and the id of the first slot at the minimum, also where the minimum is
    -0.0 in one range and +0.0 in an earlier one."""
    case = cases.split_case(name, s, 64, 2)
    pack = torch.as_tensor(cases.pack(case))
    rays = torch.as_tensor(case["rays"])
    cid = torch.as_tensor(case["order_g"][:, 0])
    t, tri = cuda_ctiles.tile_sweep_plain(pack, rays, cid, tie="slot")
    _t, any_tri = cuda_ctiles.tile_sweep_plain(pack, rays, cid)
    start = (torch.full(t.shape, np.inf), torch.full(t.shape, I32_MAX,
                                                     dtype=torch.int32))
    hits = tri != I32_MAX
    assert hits.any()
    for w in SPLITS:
        got = split_sweep(pack, rays, cid, w, True, start)
        assert torch.equal(_bits(got[0]), _bits(t))
        assert torch.equal(got[1], tri)
        assert torch.equal(split_sweep(pack, rays, cid, w, False),
                           any_tri != I32_MAX)
    if name == "signed_zero":
        # the first slot's sign: blocks whose order starts 0, 1 (-0.0 then
        # +0.0) keep -0.0, those that start 1 keep +0.0
        zero = hits & (t == 0.0)
        assert zero.any()
        assert torch.signbit(t[zero]).any() and (~torch.signbit(t[zero])).any()
    if name == "nan_and_dead":
        dead = ~(rays[:, 6] >= rays[:, 7])
        assert dead.any() and not hits[dead].any()


def test_ranges_cover_the_group_in_order():
    """Each W's ranges are the group's chunks, in slot order, once each."""
    for g in (1, 2, 5, 8):
        for s in (1, 16, 96, 128, 256):
            whole = [(i, j) for i in range(g) for j in range(s)]
            for w in SPLITS:
                got = [(i, j) for part in ranges(g, s, w)
                       for i, j0, j1 in part for j in range(j0, j1)]
                assert got == whole


@pytest.mark.parametrize("t_lanes", [1, 16, 64, 256])
def test_split_rule(t_lanes):
    """split_warps returns a W of SPLITS for every size from 1 to 65,536;
    W = 1 for every stage that fills the card (its slots more than
    SPLIT_K2 / 4 times the card's warps: every warp takes more than two of
    them a pass, even at the stage's end); a W that never grows with the
    size; and W^2 x slots <= SPLIT_K2 x warps wherever W > 1."""
    slots = -(-t_lanes // 32)
    k2 = cuda_cascade.SPLIT_K2
    for resident, sms in ((24, 132), (32, 132), (24, 114), (48, 8)):
        warps = resident * sms
        prev = max(SPLITS)
        for size in range(1, 65537):
            w = cuda_cascade.split_warps(size, t_lanes, resident, sms)
            assert w in SPLITS
            assert w <= prev
            prev = w
            if 4 * size * slots > k2 * warps:
                assert w == 1
            else:
                assert w * w * size * slots <= k2 * warps
                assert w == max(SPLITS) or (
                    4 * w * w * size * slots > k2 * warps)
        assert cuda_cascade.split_warps(1, t_lanes, resident, sms) == 8


def test_split_rule_on_the_measured_stages():
    """The W the rule gives the stage sizes of the main path's shadow
    calls (blocks of 64) and of the packets route (blocks of 256) on the
    H100 (132 SMs, 24 resident warps of the stage kernel), as PERF.md §6
    lists them."""
    rule = lambda size, t: cuda_cascade.split_warps(size, t, 24, 132)
    assert [rule(2 ** e, 64) for e in range(16, 4, -1)] == [
        1, 1, 1, 1, 2, 2, 4, 4, 8, 8, 8, 8]
    assert [rule(2 ** e, 256) for e in range(12, 4, -1)] == [
        1, 1, 2, 2, 4, 4, 8, 8]
