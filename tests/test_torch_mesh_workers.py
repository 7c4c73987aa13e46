"""The mesh's concurrent workers (parallel.mesh): one worker thread a shard
on the CPU, a barrier before each compaction, counts made under
utils.sync.lock, and a worker's failure raised by the render.

Each virtual CPU entry of a mesh is its own worker here, so these tests run
the barrier and the shared compaction width that the cards' workers run on
the GPU. A run with every shard on one worker (the sequential schedule)
must give the same image, the same host reads and the same kernel calls.
"""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import tracer, wavefront
from path_tracer_ai_tpu_torch.parallel import mesh as mesh_mod
from path_tracer_ai_tpu_torch.parallel.mesh import (
    make_mesh,
    render_sharded,
    render_sharded_wavefront,
)
from path_tracer_ai_tpu_torch.scene.camera import default_camera
from path_tracer_ai_tpu_torch.scene.scene import blob_scene
from path_tracer_ai_tpu_torch.utils import sync

S2 = RenderSettings(width=24, height=16, samples_per_pixel=2, max_bounces=3,
                    seed=5)
KW = dict(pix_chunk=1 << 7, compact_min_bucket=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return blob_scene(subdivisions=2, device="cpu")


@pytest.fixture(scope="module")
def camera():
    return default_camera("cpu")


@pytest.fixture(scope="module")
def single(scene, camera):
    return wavefront.render(scene, camera, S2, wave_size=1 << 11,
                            device="cpu")


def _sequential(monkeypatch):
    """Every shard on one worker: the schedule before the workers."""
    monkeypatch.setattr(mesh_mod, "_groups",
                        lambda shards: [list(range(len(shards)))])


def _counted(monkeypatch):
    """Counts tile_sweep's calls (its plain version on the CPU) by thread."""
    calls = []
    real = cuda_ctiles.tile_sweep

    def spy(*args, **kw):
        calls.append(threading.current_thread().name)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_ctiles, "tile_sweep", spy)
    return calls


def test_groups_one_worker_a_shard_on_cpu_one_a_card_on_cuda():
    cpu = [torch.device("cpu")] * 4
    assert mesh_mod._groups(cpu) == [[0], [1], [2], [3]]
    cards = [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    assert mesh_mod._groups(cards) == [[0, 2], [1, 3]]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_workers_match_single_device_and_sequential(scene, camera, single,
                                                    monkeypatch, shape):
    """A (2, 2) and a (4, 1) mesh of CPU entries, four workers: bitwise the
    single-device render at 2 spp and the sequential schedule, with the same
    host reads and tile_sweep calls, made from four threads."""
    mesh = make_mesh(*shape, ["cpu"] * 4)
    calls = _counted(monkeypatch)
    sync.reset()
    stats = wavefront.RenderStats()
    img = render_sharded_wavefront(scene, camera, S2, mesh, stats=stats, **KW)
    syncs, threads = sync.count, collections.Counter(calls)
    np.testing.assert_array_equal(img, single)
    assert len(threads) == 4

    _sequential(monkeypatch)
    calls.clear()
    sync.reset()
    seq_stats = wavefront.RenderStats()
    seq = render_sharded_wavefront(scene, camera, S2, mesh, stats=seq_stats,
                                   **KW)
    np.testing.assert_array_equal(seq, img)
    assert sync.count == syncs
    assert len(calls) == sum(threads.values())
    assert (seq_stats.closest_rays, seq_stats.shadow_rays) == (
        stats.closest_rays, stats.shadow_rays)


def test_fused_workers_match_single_device(scene, camera, single,
                                           monkeypatch):
    """render_sharded over a (2, 2) mesh: four workers, bitwise the
    single-device render at 2 spp."""
    traced = []
    real = tracer.trace_paths

    def spy(*args, **kw):
        traced.append(threading.current_thread().name)
        return real(*args, **kw)

    monkeypatch.setattr(tracer, "trace_paths", spy)
    img = render_sharded(scene, camera, S2, make_mesh(2, 2, ["cpu"] * 4),
                         block_size=64, pix_chunk=1 << 7)
    np.testing.assert_array_equal(img, single)
    assert len(set(traced)) == 4


def test_workers_share_one_compaction_width(scene, camera, monkeypatch):
    """Every shard compacts at the same bounces to the bucket of the largest
    live count, after every worker has posted its count (the barrier)."""
    seen = []
    real = wavefront._Lanes.compact

    def spy(lanes, n_live, bucket):
        seen.append((threading.current_thread().name, n_live, bucket))
        return real(lanes, n_live, bucket)

    monkeypatch.setattr(wavefront._Lanes, "compact", spy)
    waits = []
    real_wait = threading.Barrier.wait

    def wait(barrier, *a):
        waits.append(threading.current_thread().name)
        return real_wait(barrier, *a)

    monkeypatch.setattr(threading.Barrier, "wait", wait)
    settings = S2.replace(max_bounces=4)
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    render_sharded_wavefront(scene, camera, settings, mesh, **KW)
    p_loc, chunk, _xs, _ys = mesh_mod._layout(mesh.shape, settings, 64,
                                              KW["pix_chunk"])
    by_thread = collections.Counter(waits)  # bounces 1-3 of each chunk
    assert len(by_thread) == 4
    assert set(by_thread.values()) == {3 * (p_loc // chunk)}
    assert seen, "no compaction at these settings"
    buckets = collections.defaultdict(set)
    for i, (thread, n_live, bucket) in enumerate(seen):
        buckets[thread].add(bucket)
        assert n_live <= bucket
    assert len(buckets) == 4
    assert len({frozenset(b) for b in buckets.values()}) == 1


@pytest.mark.parametrize("render", ["wavefront", "fused"])
def test_a_failing_worker_fails_the_render(scene, camera, monkeypatch,
                                           render):
    """One shard's error ends the render with that error: the other workers
    stop at their barrier (none waits forever) and no image is returned."""
    target = threading.Event()

    def boom(*args, **kw):
        if not target.is_set():
            target.set()
            raise RuntimeError("shard failed")
        return real(*args, **kw)

    if render == "wavefront":
        real = wavefront._Lanes.step
        monkeypatch.setattr(wavefront._Lanes, "step",
                            lambda lanes, *a: boom(lanes, *a))
        run = lambda: render_sharded_wavefront(
            scene, camera, S2, make_mesh(2, 2, ["cpu"] * 4), **KW)
    else:
        real = tracer.trace_paths
        monkeypatch.setattr(tracer, "trace_paths", boom)
        run = lambda: render_sharded(scene, camera, S2,
                                     make_mesh(2, 2, ["cpu"] * 4),
                                     block_size=64, pix_chunk=1 << 7)
    with pytest.raises(RuntimeError, match="shard failed"):
        run()


def test_counts_are_exact_from_many_threads():
    """sync's count and a wrapper's launch count, bumped from sixteen
    threads at once with the interpreter switching threads as often as it
    can, lose no update."""

    sync.reset()
    cuda_ctiles.reset_launches()

    def bump():
        for _ in range(5000):
            sync.note()
            with sync.lock:
                cuda_ctiles.launches += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert sync.count == cuda_ctiles.launches == 16 * 5000
    cuda_ctiles.reset_launches()
    assert cuda_ctiles.launches == cuda_ctiles.generic_launches == 0


# --- process workers (the schedule of a mesh that spans two cards) ---------

@pytest.fixture
def processes(monkeypatch):
    """The mesh's workers as processes (as on a mesh of two cards or more),
    here one a CPU entry."""
    from path_tracer_ai_tpu_torch.parallel import workers

    monkeypatch.setattr(workers, "use_processes", lambda devices: True)
    return workers


def test_use_processes_where_the_mesh_spans_two_cards():
    from path_tracer_ai_tpu_torch.parallel import workers

    cards = [torch.device("cuda", i) for i in range(2)]
    assert workers.use_processes(cards)
    assert not workers.use_processes(cards[:1])
    assert not workers.use_processes([torch.device("cuda", 0)] * 2)
    assert not workers.use_processes([torch.device("cpu")] * 4)


def test_process_workers_match_threads(scene, camera, single, processes,
                                       monkeypatch):
    """Four worker processes: bitwise the single-device render at 2 spp
    (both schedulers), with the host reads and ray counts of the threads,
    each process's counts added to this process's."""
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    sync.reset()
    stats = wavefront.RenderStats()
    img = render_sharded_wavefront(scene, camera, S2, mesh, stats=stats, **KW)
    syncs = sync.count
    np.testing.assert_array_equal(img, single)
    assert processes.process_workers([torch.device("cpu")] * 4).alive
    np.testing.assert_array_equal(
        render_sharded(scene, camera, S2, mesh, block_size=64,
                       pix_chunk=1 << 7), single)

    monkeypatch.setattr(processes, "use_processes", lambda devices: False)
    sync.reset()
    thread_stats = wavefront.RenderStats()
    render_sharded_wavefront(scene, camera, S2, mesh, stats=thread_stats,
                             **KW)
    assert sync.count == syncs
    assert (thread_stats.closest_rays, thread_stats.shadow_rays) == (
        stats.closest_rays, stats.shadow_rays)


def test_a_failing_process_fails_the_render(scene, camera, single,
                                            processes):
    """An error in a worker process fails the render with its traceback;
    the processes are stopped, and the next render starts new ones."""
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    with pytest.raises(RuntimeError, match="backend 'no-such' is unknown"):
        render_sharded_wavefront(scene, camera, S2, mesh, backend="no-such",
                                 **KW)
    np.testing.assert_array_equal(
        render_sharded_wavefront(scene, camera, S2, mesh, **KW), single)


def test_counts_cross_processes_exactly():
    """A worker's counts (counts_snapshot) added to this process's."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_cascade,
        cuda_sweep,
        kslots,
        worklist,
    )
    from path_tracer_ai_tpu_torch.parallel import workers

    workers.counts_reset()
    stage = ("cascade_stage_any", 64, 128, 2)
    with sync.lock:
        cuda_ctiles.launches += 3
        cuda_ctiles.generic_launches += 1
        cuda_ctiles.launch_shapes[(64, 128, 2)] = [3, 30]
        cuda_sweep.launches["anyhit_sweep"] += 2
        cuda_cascade.launches["cascade_stage_any"] += 2
        cuda_cascade.launch_shapes[stage] = [2, 20]
        worklist.fallback_counts["rays"] += 5
        kslots.queries += 1
        kslots._counts[torch.device("cpu")] = torch.arange(5)
    note_line = sys._getframe().f_lineno + 1
    sync.note()
    snap = workers.counts_snapshot()
    workers.counts_add(snap)
    assert (cuda_ctiles.launches, cuda_ctiles.generic_launches) == (6, 2)
    assert cuda_ctiles.launch_shapes[(64, 128, 2)] == [6, 60]
    assert cuda_sweep.launches["anyhit_sweep"] == 4
    assert cuda_cascade.launches["cascade_stage_any"] == 4
    assert cuda_cascade.launch_shapes[stage] == [4, 40]
    assert worklist.fallback_counts["rays"] == 10 and sync.count == 2
    assert sync.sites == {f"{__name__}:{note_line}": 2}
    assert kslots.read_overflow_counts() == {
        "queries": 2, "rays": 0, "over_supers": 2, "over_clusters": 4,
        "phantom_only": 6, "slots": 8}
    workers.counts_reset()
    assert workers.counts_snapshot()["syncs"] == 0


def test_plain_round_trip(scene):
    """to_plain / from_plain carry a scene's tensors as arrays, bit for
    bit, in their NamedTuple types."""
    from path_tracer_ai_tpu_torch.parallel import workers

    back = workers.from_plain(workers.to_plain(scene))
    assert type(back) is type(scene)
    for part, part_back in zip(scene, back):
        assert type(part_back) is type(part)
        for t, t_back in zip(part, part_back):
            assert t_back.dtype == t.dtype and torch.equal(t_back, t)
