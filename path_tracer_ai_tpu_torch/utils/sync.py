"""Counts the host reads of device values made by the render loop.

Where the JAX package keeps a loop bound on the device (a while_loop
condition, a dynamic trip count), eager torch reads it back to the host,
which waits for the device to drain. `host_int` does such a read and
counts it, so a run can report how many it made (PERF.md).

`lock` guards this count and the port's other module-level counts (the
kernel wrappers' launches, the overflow counts): the mesh's workers
(parallel.mesh) update them from several threads at once, and `x += 1`
from two threads can lose an update.
"""

from __future__ import annotations

import threading

import torch

count = 0
lock = threading.Lock()


def reset() -> None:
    global count
    with lock:
        count = 0


def note() -> None:
    """Count a host read made elsewhere (e.g. torch.nonzero's size)."""
    global count
    with lock:
        count += 1


def host_int(x) -> int:
    note()
    return int(x.item()) if torch.is_tensor(x) else int(x)
