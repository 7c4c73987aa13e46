"""Counts the host reads of device values made by the render loop.

Where the JAX package keeps a loop bound on the device (a dynamic trip
count, a static cap beside a dynamic bound), eager torch may read it back
to the host, which waits for the device to drain. `host_int` does such a
read and counts it, so a run can report how many it made (PERF.md), and
by call site (`sites`: "module:line" of the caller -> reads).

The packet cascades' while_loop (any_hit_packets, closest_hit_packets)
runs on the card, in the cascade stage kernel (accel.cuda_cascade): they
read nothing back (but the exact cull's live block count). So do the
fused cascades' (any_hit_fused, closest_hit_fused; the same module),
which read one value a cascade, the candidate ids' range check, and the
perray queries' (closest_hit_perray, any_hit_perray), which read one a
call, the overflow count. So do ctiles' closest and any-hit queries at
both levels (accel.ctiles: the live-block count and the live tile count
stay on the card, read by the block_cull and slot_sweep kernels) and the
pair tiles' tables and sweep (accel.pairs: the tile count stays on the
card; its compaction builds a static-size index list). Still read on the
host, as the reference's lax.cond choices: the overflow fallbacks'
counts (accel.worklist, accel.pairs); and the bounce loop's live counts
and the counters, which the reference reads too; then the exact shadow
cull's live-block count, the worklist's and kslots' table sizes, and the
host-stepped comparison loops (the stages' and the kernels' plain
versions, traverse._cascade_traverse), one read a vote or a bound.

`lock` guards these counts and the port's other module-level counts (the
kernel wrappers' launches, the overflow counts): the mesh's workers
(parallel.mesh) update them from several threads at once, and `x += 1`
from two threads can lose an update.
"""

from __future__ import annotations

import sys
import threading

import torch

count = 0
sites: dict = {}
lock = threading.Lock()


def reset() -> None:
    global count
    with lock:
        count = 0
        sites.clear()


def _count(depth: int) -> None:
    global count
    frame = sys._getframe(depth + 1)
    site = f"{frame.f_globals.get('__name__')}:{frame.f_lineno}"
    with lock:
        count += 1
        sites[site] = sites.get(site, 0) + 1


def note() -> None:
    """Count a host read made elsewhere (e.g. torch.nonzero's size)."""
    _count(1)


def host_int(x) -> int:
    _count(1)
    return int(x.item()) if torch.is_tensor(x) else int(x)
