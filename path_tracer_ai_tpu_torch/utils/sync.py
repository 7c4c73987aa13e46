"""Counts the host reads of device values made by the render loop.

Where the JAX package keeps a loop bound on the device (a dynamic trip
count, a static cap beside a dynamic bound), eager torch may read it back
to the host, which waits for the device to drain. `host_int` does such a
read and counts it, so a run can report how many it made (PERF.md), and
by call site (`sites`: "module:line" of the caller -> reads).

The packet cascades' while_loop (any_hit_packets, closest_hit_packets)
runs on the card, in the cascade stage kernel (accel.cuda_cascade): they
read nothing back (but the exact cull's live block count). So does the
fused cascades' (any_hit_fused, closest_hit_fused; the same module),
which reads one value a cascade: the candidate ids' range check. Still read
on the host: the bounce loop's live counts and the counters, ctiles'
n_live / n_slots, the worklist's and kslots' table sizes, and the
host-stepped loop of traverse._cascade_traverse (the perray queries), one
read a vote.

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
