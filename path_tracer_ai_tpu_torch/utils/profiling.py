"""Timing and tracing (counterpart of utils/profiling.py).

The reference only wall-clocks the whole render (main.cpp:65-70). Here:
- `Timer` / `timed`: wall-clock scopes that wait for the card first when
  the work is on it;
- `trace`: a torch.profiler trace, written as a Chrome trace (the CLI's
  --profile).
`engine.wavefront.RenderStats` carries the Mrays/s counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from path_tracer_ai_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TRACE_FILE = "trace.json"


def _sync(x) -> None:
    """Wait for the card if `x` (a tensor or a structure of them) holds a
    CUDA tensor."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _sync(y)
    elif isinstance(x, dict):
        for y in x.values():
            _sync(y)


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the block; `sync`, a tensor (or structure of them) the block
        computes, is waited for before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            dt = time.perf_counter() - t0
            self.sections[name] = self.sections.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1e3:.1f} ms total, {n} calls, "
                         f"{total/n*1e3:.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU, and CUDA when there is a
    card) and write its Chrome trace to `log_dir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    log.info("Profiler trace written to %s", path)


def timed(fn, *args, n: int = 3, warmup: int = 1, **kw):
    """Time a callable with its first calls (builds, caches) excluded;
    returns (result, seconds a call)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kw)
    _sync(result)
    t0 = time.perf_counter()
    for _ in range(n):
        result = fn(*args, **kw)
    _sync(result)
    return result, (time.perf_counter() - t0) / n
