"""The workers that drive a mesh's shards at once (parallel.mesh).

A render hands its shards to workers in groups (mesh._groups: one group a
card on cuda, one a shard on the CPU). Each step of the render (a chunk of
pixels) runs every group's work at once, on one of two kinds of worker:

- threads of the calling process (`ThreadWorkers`), with a
  threading.Barrier where the shards meet;
- one persistent process a group (`ProcessWorkers`), with a barrier and a
  shared array of live counts between the processes. They are started the
  first time a mesh of those cards renders and then kept, so a later
  render pays only for its scene, its replicas and its steps.

Processes serve the groups where they span two cards or more
(use_processes), threads otherwise. Eager torch issues a render as many
small operations from the host, each of which takes and releases the
interpreter's lock; threads that issue them at once spend their time
handing that lock over (PERF.md, PR 11: four cards driven by four threads
took 3.1x as long as the same cards driven one after another, and by four
processes 0.38x), while processes do not share it. On one card the
groups are one: the calling thread drives it.

A process worker's counts (kernel launches by shape, host reads, overflow
counts) are its own: it sets them to 0 before each step and sends them back
with its results, and the calling process adds them to its own (under
utils.sync.lock), so that a render reads the same counts however its
shards ran. A failing worker aborts the barrier (no other waits forever)
and its traceback fails the render; the processes are then stopped.
"""

from __future__ import annotations

import atexit
import multiprocessing
import threading
import traceback

import numpy as np
import torch

from path_tracer_ai_tpu_torch.utils import sync

# Shards a process pool's shared count array holds.
MAX_SHARDS = 1024
# While True, a render's process workers trace their steps with
# torch.profiler and report their cards' kernel seconds, which are added
# to `device_seconds` (a diagnosis: chip_smoke.py's busy share a card).
PROFILE = False
device_seconds: dict = {}  # "cuda:i" -> kernel seconds reported


def use_processes(group_devices) -> bool:
    """Whether the groups (one device each) run on processes: where they
    span two cards or more."""
    return len({d for d in group_devices if d.type == "cuda"}) >= 2


# ---- counts ---------------------------------------------------------------

def _count_modules():
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_cascade,
        cuda_closest,
        cuda_ctiles,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
        kslots,
        pairs,
        worklist,
    )

    return (dict(ctiles=cuda_ctiles, anyhit=cuda_anyhit,
                 closest=cuda_closest, items=cuda_items,
                 kslots=cuda_kslots),
            cuda_ctiles, (cuda_sweep, cuda_cascade), kslots, pairs, worklist)


def counts_reset() -> None:
    """Sets every count of this process to 0."""
    wrappers, _ctiles, by_name, kslots, pairs, worklist = _count_modules()
    for mod in (*wrappers.values(), *by_name):
        mod.reset_launches()
    kslots.reset_overflow_counts()
    worklist.reset_fallback_counts()
    pairs.reset_fallback_counts()
    sync.reset()


def counts_snapshot() -> dict:
    """This process's counts, as plain values."""
    wrappers, ctiles, by_name, kslots, pairs, worklist = _count_modules()
    cascade = by_name[1]
    return {
        "syncs": sync.count,
        "sync_sites": dict(sync.sites),
        "launches": {k: (m.launches, m.generic_launches)
                     for k, m in wrappers.items()},
        # the wrappers that count by kernel name: cuda_sweep, cuda_cascade
        "by_name": [(dict(m.launches), dict(m.generic_launches))
                    for m in by_name],
        "shapes": {k: list(v) for k, v in ctiles.launch_shapes.items()},
        "cascade_shapes": {k: list(v)
                           for k, v in cascade.launch_shapes.items()},
        "worklist": dict(worklist.fallback_counts),
        "pairs": dict(pairs.fallback_counts),
        "kslots": (kslots.queries, {str(d): t.tolist()
                                    for d, t in kslots._counts.items()}),
    }


def counts_add(snap: dict) -> None:
    """Adds a worker's counts (counts_snapshot) to this process's."""
    wrappers, ctiles, by_name, kslots, pairs, worklist = _count_modules()
    with sync.lock:
        sync.count += snap["syncs"]
        for site, n in snap["sync_sites"].items():
            sync.sites[site] = sync.sites.get(site, 0) + n
        for k, (n, g) in snap["launches"].items():
            wrappers[k].launches += n
            wrappers[k].generic_launches += g
        for mod, (n, g) in zip(by_name, snap["by_name"]):
            for name in mod.launches:
                mod.launches[name] += n[name]
                mod.generic_launches[name] += g[name]
        for shapes, add in ((ctiles.launch_shapes, snap["shapes"]),
                            (by_name[1].launch_shapes,
                             snap["cascade_shapes"])):
            for key, (n, tiles) in add.items():
                shape = shapes.setdefault(key, [0, 0])
                shape[0] += n
                shape[1] += tiles
        for counts, add in ((worklist.fallback_counts, snap["worklist"]),
                            (pairs.fallback_counts, snap["pairs"])):
            for k, v in add.items():
                counts[k] += v
        for dev, sec in snap.get("device_seconds", {}).items():
            device_seconds[dev] = device_seconds.get(dev, 0.0) + sec
        queries, by_dev = snap["kslots"]
        kslots.queries += queries
        for dev, vals in by_dev.items():
            dev = torch.device(dev)
            old = kslots._counts.get(dev)
            new = torch.as_tensor(vals, dtype=torch.int64,
                                  device=old.device if old is not None
                                  else "cpu")
            kslots._counts[dev] = new if old is None else old + new


# ---- moving tensors between processes -------------------------------------

def to_plain(x):
    """x with every tensor (in nested tuples, NamedTuples, lists, dicts and
    SimpleNamespaces) replaced by a numpy array, which pickles by value
    (torch's own reduction would go through shared memory)."""
    from types import SimpleNamespace

    if torch.is_tensor(x):
        return _Array(x.detach().cpu().numpy())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_plain(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: to_plain(v) for k, v in x.items()}
    if isinstance(x, SimpleNamespace):
        return SimpleNamespace(**to_plain(vars(x)))
    return x


def from_plain(x):
    """Inverse of to_plain: CPU tensors in place of its arrays."""
    from types import SimpleNamespace

    if isinstance(x, _Array):
        return torch.from_numpy(x.array)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(from_plain(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(from_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: from_plain(v) for k, v in x.items()}
    if isinstance(x, SimpleNamespace):
        return SimpleNamespace(**from_plain(vars(x)))
    return x


class _Array:
    """A numpy array standing for a tensor in to_plain's output."""

    def __init__(self, array: np.ndarray):
        self.array = array


# ---- threads --------------------------------------------------------------

class ThreadWorkers:
    """Each group's step in a thread of its own (a single group inline).
    meet(depth, counts) posts a group's live counts {shard: n} and returns
    the largest of every shard's, once every group has posted."""

    def __init__(self, n_groups: int, n_shards: int):
        self.n_groups = n_groups
        self.barrier = threading.Barrier(n_groups)
        self.live = [[0] * n_shards, [0] * n_shards]

    def meet(self, depth: int, counts: dict) -> int:
        slot = self.live[depth % 2]  # a fast group may post the next depth
        for i, n in counts.items():
            slot[i] = n
        self.barrier.wait()
        return max(slot)

    def run(self, fns: list) -> list:
        """[fn() for fn in fns], at once; the first error is raised once
        every thread has ended."""
        if len(fns) == 1:
            return [fns[0]()]
        out = [None] * len(fns)
        errors = [None] * len(fns)

        def body(i):
            try:
                out[i] = fns[i]()
            except BaseException as err:  # noqa: BLE001 (raised below)
                errors[i] = err
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(i,),
                                    name=f"mesh-worker-{i}", daemon=True)
                   for i in range(len(fns))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        found = [e for e in errors if e is not None]
        if found:
            raise next((e for e in found
                        if not isinstance(e, threading.BrokenBarrierError)),
                       found[0])
        return out


# ---- processes ------------------------------------------------------------

class ProcessWorkers:
    """One persistent worker process a group device (spawned, so that each
    starts its own CUDA context). `start(job)` hands every process the
    render (its tensors through to_plain); `run(steps)` sends process i
    steps[i], a (group, step) pair, and returns their results, after
    adding each process's counts to this one's."""

    def __init__(self, devices):
        ctx = multiprocessing.get_context("spawn")
        self.barrier = ctx.Barrier(len(devices))
        self.live = ctx.Array("q", 2 * MAX_SHARDS, lock=False)
        self.conns, self.procs = [], []
        for dev in devices:
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_process_main,
                               args=(str(dev), there, self.barrier,
                                     self.live),
                               name=f"mesh-worker-{dev}", daemon=True)
            proc.start()
            there.close()
            self.conns.append(here)
            self.procs.append(proc)

    def _exchange(self, msgs: list) -> list:
        try:
            for conn, msg in zip(self.conns, msgs):
                conn.send(msg)
            replies = [conn.recv() for conn in self.conns]
        except (EOFError, OSError) as err:
            self.close()
            raise RuntimeError(f"a mesh worker process ended: {err!r}")
        errors = [r[1] for r in replies if r[0] == "error"]
        if errors:
            self.close()
            first = next((e for e in errors if "BrokenBarrierError" not in e),
                         errors[0])
            raise RuntimeError(f"a mesh worker failed:\n{first}")
        return [r[1] for r in replies]

    def start(self, job) -> None:
        plain = to_plain(job)
        self._exchange([("job", plain)] * len(self.conns))

    def run(self, steps: list) -> list:
        out = []
        for result, counts in self._exchange(
                [("step",) + tuple(s) for s in steps]):
            counts_add(counts)
            out.append(from_plain(result))
        return out

    @property
    def alive(self) -> bool:
        return bool(self.procs) and all(p.is_alive() for p in self.procs)

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(("stop",))
            except (OSError, ValueError):
                pass
            conn.close()
        for proc in self.procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join()
        self.conns, self.procs = [], []


_pools: dict = {}
_pools_lock = threading.Lock()


def process_workers(devices) -> ProcessWorkers:
    """The persistent process pool of these group devices (started at
    first use)."""
    key = tuple(str(d) for d in devices)
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None or not pool.alive:
            pool = _pools[key] = ProcessWorkers(devices)
        return pool


@atexit.register
def close_all() -> None:
    """Stops every pool's processes."""
    with _pools_lock:
        for pool in _pools.values():
            pool.close()
        _pools.clear()


def kernel_seconds(prof) -> dict:
    """{"cuda:i": seconds} of the device kernels in a torch.profiler trace
    (record_function ranges, which also appear on the device, left out)."""
    out = {}
    for e in prof.events():
        if (str(e.device_type).endswith("CUDA")
                and e.key not in ("closest_wave", "shadow_wave")
                and not e.key.startswith(("worklist_", "kslots_"))):
            dev = f"cuda:{e.device_index}"
            out[dev] = out.get(dev, 0.0) + e.time_range.elapsed_us() / 1e6
    return out


class _profiled:
    """Traces the block with torch.profiler when `on` (synchronising the
    current card at its end); yields a dict that then holds kernel_seconds
    of the trace."""

    def __init__(self, on: bool):
        self.on, self.out = on, {}

    def __enter__(self) -> dict:
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self.out

    def __exit__(self, *exc):
        if self.on:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.out.update(kernel_seconds(self.prof))


def _process_main(dev_str: str, conn, barrier, live) -> None:
    """A worker process: takes a render ("job"), then runs its steps
    ("step", group, step) through mesh.run_step until "stop"."""
    dev = torch.device(dev_str)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh

    state = {}

    def meet(depth: int, counts: dict) -> int:
        n = state["job"].n_shards
        base = (depth % 2) * n  # a fast process may post the next depth
        for i, c in counts.items():
            live[base + i] = c
        barrier.wait()
        return max(live[base:base + n])

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] == "stop":
            return
        try:
            if msg[0] == "job":
                job = from_plain(msg[1])
                for name, value in job.config.items():
                    setattr(wavefront, name, value)
                state = {"job": job, "ctx": mesh.step_context(job)}
                reply = None
            else:
                counts_reset()
                with _profiled(state["job"].profile) as kernel_seconds:
                    result = mesh.run_step(state["job"], state["ctx"],
                                           msg[1], msg[2], meet)
                counts = counts_snapshot()
                counts["device_seconds"] = kernel_seconds
                reply = (to_plain(result), counts)
            conn.send(("ok", reply))
        except BaseException:  # noqa: BLE001 (sent to the caller)
            barrier.abort()
            conn.send(("error", traceback.format_exc()))

