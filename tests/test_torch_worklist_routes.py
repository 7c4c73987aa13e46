"""The port's worklist sort modes and overflow-fallback routes against the
JAX package's and brute force (tolerances as in
tests/test_torch_worklist.py): sort=False and the "origin" / "origoct"
keys; overflow through accel.pairs on the wave itself, on a compacted wave,
and through the packet cascades over the whole wave.
"""

import pytest

from path_tracer_ai_tpu_torch.accel import worklist
from tests.test_torch_worklist import (  # noqa: F401
    _camera_rays,
    _check,
    _one_torch_thread,
    _rays,
    _scene,
)


@pytest.mark.parametrize("sort,sort_mode", [(False, "dir"), (True, "origin"),
                                            (True, "origoct")])
def test_worklist_sort_modes(rng, sort, sort_mode):
    ja, pa, ptris = _scene(rng, 400, 16, super_size=4)
    o, d, tm = _rays(rng, 256, t_max=None)
    _check(ja, pa, ptris, o, d, tm, sort=sort, sort_mode=sort_mode)


def test_fallback_routes_counted(rng):
    """Overflow rays go through accel.pairs on the wave itself while it holds
    at most fallback_compact rays, on a compacted wave while at most that
    many overflowed, and through the packet cascade over the whole wave
    beyond; every route exact."""
    ja, pa, ptris = _scene(rng, 500, 12, super_size=4)
    o, d, tm = _camera_rays(rng, 512)
    routes = {}
    for compact in (4096, 256, 16):
        worklist.reset_fallback_counts()
        _check(ja, pa, ptris, o, d, tm, any_hit=compact == 16, cap=10,
               fallback_compact=compact)
        routes[compact] = dict(worklist.fallback_counts)
    for compact in (4096, 256):
        c = routes[compact]
        assert c["calls"] == 1 and c["whole_wave"] == 0
        assert 0 < c["rays"] == c["pairs_rays"] <= compact
        assert 0 < c["rays"] <= c["blocks"] * 8
    # closest and any hit each took the whole wave
    assert routes[16]["whole_wave"] == 2 and routes[16]["pairs_rays"] == 0
    assert routes[16]["rays"] == 2 * routes[256]["rays"]
