"""Multi-device rendering (parallel.mesh) on a mesh of 8 virtual CPU
entries, case for case with tests/test_mesh.py, and against the JAX
package's mesh.

The RNG streams are keyed by (pixel, global sample), so every mesh shape
traces the single device's samples. At 2 spp each pixel sums two values,
which gives the same bits in any order: every shape must equal the
single-device image bit for bit. At the reference's 4 spp settings the
sums group differently, held at its atol 1e-4; against the JAX mesh at
the RMSE_REL of tests/test_torch_render.py.
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.engine import wavefront
from path_tracer_ai_tpu_torch.io import checkpoint as ckpt_io
from path_tracer_ai_tpu_torch.parallel import mesh as mesh_mod
from path_tracer_ai_tpu_torch.parallel.mesh import (
    make_mesh,
    render_sharded,
    render_sharded_wavefront,
    render_tiled,
)
from path_tracer_ai_tpu_torch.scene.camera import default_camera
from path_tracer_ai_tpu_torch.scene.scene import build_scene_from_arrays
from tests.test_torch_render import RMSE_REL

CPU8 = ["cpu"] * 8
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
TRIS = [
    ([-8, 0, -8], [8, 0, -8], [8, 0, 8], [0, 1, 0], 1),
    ([-8, 0, -8], [8, 0, 8], [-8, 0, 8], [0, 1, 0], 1),
    ([-8, 0, -8], [-8, 4, -8], [8, 4, -8], [0, 0, 1], 1),
    ([-1, 0, -1], [1, 0, -1], [0, 3, -1], [0, 0, 1], 0),
]
SETTINGS = RenderSettings(width=40, height=24, samples_per_pixel=4,
                          max_bounces=2, seed=3)
SETTINGS_2SPP = SETTINGS.replace(samples_per_pixel=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays():
    col = lambda i: [t[i] for t in TRIS]
    n = col(3)
    uv = [[0, 0]] * len(TRIS)
    return col(0), col(1), col(2), n, n, n, uv, uv, uv, col(4)


@pytest.fixture(scope="module")
def scene():
    return build_scene_from_arrays(*_arrays(), device="cpu")


@pytest.fixture(scope="module")
def camera():
    return default_camera("cpu")


def _single(scene, camera, settings, **kw):
    return wavefront.render(scene, camera, settings, wave_size=1 << 11,
                            block_size=64, device="cpu", **kw)


@pytest.fixture(scope="module")
def single_device_image(scene, camera):
    return _single(scene, camera, SETTINGS)


@pytest.fixture(scope="module")
def single_device_image_2spp(scene, camera):
    return _single(scene, camera, SETTINGS_2SPP)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shapes_match_single_device(scene, camera, single_device_image,
                                         shape):
    """tests/test_mesh.py's case: render_sharded on every factorization
    reproduces the single-device image up to the f32 sum order."""
    img = render_sharded(scene, camera, SETTINGS, make_mesh(*shape, CPU8),
                         block_size=64, pix_chunk=1 << 9)
    np.testing.assert_allclose(img, single_device_image, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shapes_bitwise_at_2spp(scene, camera, single_device_image_2spp,
                                     shape):
    mesh = make_mesh(*shape, CPU8)
    for img in (render_sharded(scene, camera, SETTINGS_2SPP, mesh,
                               block_size=64, pix_chunk=1 << 9),
                render_sharded_wavefront(scene, camera, SETTINGS_2SPP, mesh,
                                         pix_chunk=1 << 9,
                                         compact_min_bucket=64)):
        np.testing.assert_array_equal(img, single_device_image_2spp)


def test_render_tiled_wrapper(scene, camera, single_device_image):
    img = render_tiled(scene, camera, SETTINGS, n_devices=8, device="cpu",
                       block_size=64, pix_chunk=1 << 9)
    np.testing.assert_allclose(img, single_device_image, atol=1e-4)


def test_sharded_exact_cull_matches_single_device(scene, camera,
                                                  single_device_image,
                                                  monkeypatch):
    """The exact-cull shadow engine under the mesh reproduces the
    single-device image: occlusion is exact under any cull."""
    monkeypatch.setattr(wavefront, "HYBRID_OCCLUDE_KW",
                        dict(engine="packets", group_size=2, exact_cull=4))
    img = render_sharded(scene, camera, SETTINGS, make_mesh(4, 2, CPU8),
                         block_size=64, pix_chunk=1 << 9)
    np.testing.assert_allclose(img, single_device_image, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_wavefront_scheduler_matches_single_device(scene, camera, shape):
    """The host-stepped scheduler over the mesh (per-shard compaction, the
    sum over samples) reproduces the single-device image and counts rays
    (its padding pixels, which replay pixel 0, count too)."""
    stats = wavefront.RenderStats()
    img = render_sharded_wavefront(
        scene, camera, SETTINGS, make_mesh(*shape, CPU8), block_size=64,
        pix_chunk=1 << 9, stats=stats, compact_min_bucket=64)
    np.testing.assert_allclose(img, _single(scene, camera, SETTINGS),
                               atol=1e-4)
    assert stats.total_rays > 0


def test_wavefront_scheduler_checkpoint_resume(scene, camera, tmp_path,
                                               monkeypatch):
    """Per-pass checkpoints: resuming from the first pass's checkpoint
    reproduces the uninterrupted image."""
    mesh = make_mesh(2, 2, CPU8)
    ck = str(tmp_path / "mesh.npz")
    saves = []
    real_save = ckpt_io.save

    def record_save(path, acc, cnt, next_sample, fp):
        saves.append((np.array(acc), np.array(cnt), next_sample, fp))
        real_save(path, acc, cnt, next_sample, fp)

    monkeypatch.setattr(ckpt_io, "save", record_save)
    kw = dict(block_size=64, pix_chunk=1 << 9, compact_min_bucket=64)
    img_full = render_sharded_wavefront(scene, camera, SETTINGS, mesh,
                                        checkpoint_path=ck,
                                        checkpoint_every=1, **kw)
    monkeypatch.setattr(ckpt_io, "save", real_save)
    assert len(saves) >= 2  # one a pass: spp 4 over 2 samples -> 2 passes
    acc, cnt, next_sample, fp = saves[0]
    assert next_sample < SETTINGS.samples_per_pixel
    ckpt_io.save(ck, acc, cnt, next_sample, fp)
    img_resumed = render_sharded_wavefront(scene, camera, SETTINGS, mesh,
                                           checkpoint_path=ck, **kw)
    np.testing.assert_allclose(img_resumed, img_full, atol=1e-6)


def test_wavefront_scheduler_rejects_midpass_checkpoint(scene, camera,
                                                        tmp_path):
    mesh = make_mesh(2, 4, CPU8)
    ck = str(tmp_path / "midpass.npz")
    npix = SETTINGS.width * SETTINGS.height
    fp = ckpt_io.fingerprint(SETTINGS, scene.triangles.count, SETTINGS.seed)
    ckpt_io.save(ck, np.zeros((npix, 3), np.float32),
                 np.zeros((npix,), np.int32), 3, fp)  # 3 % 4 != 0
    with pytest.raises(ValueError, match="not a multiple"):
        render_sharded_wavefront(scene, camera, SETTINGS, mesh,
                                 block_size=64, pix_chunk=1 << 9,
                                 checkpoint_path=ck)


def test_render_tiled_fused_rejects_unsupported_kwargs(scene, camera):
    with pytest.raises(ValueError, match="base render surface"):
        render_tiled(scene, camera, SETTINGS, n_devices=8, device="cpu",
                     scheduler="fused", stats=wavefront.RenderStats(),
                     block_size=64, pix_chunk=1 << 9)


def test_render_tile_devices_rejects_pool_scheduler(scene, camera):
    with pytest.raises(ValueError, match="scheduler='wave'"):
        wavefront.render(scene, camera, SETTINGS, tile_devices=8,
                         scheduler="pool", block_size=64, device="cpu")


def test_render_tiled_fused_base_surface(scene, camera, single_device_image):
    img = render_tiled(scene, camera, SETTINGS, n_devices=8, device="cpu",
                       scheduler="fused", block_size=64, pix_chunk=1 << 9)
    np.testing.assert_allclose(img, single_device_image, atol=1e-4)


def test_mesh_holds_its_entries(monkeypatch):
    """tests/test_mesh.py::test_output_shards_live_on_distinct_devices: a
    mesh covers the devices it is given, in [tiles, samples] order; the
    CPU mesh is 8 virtual entries; too few devices refuse."""
    mesh = make_mesh(8, 1, CPU8)
    assert mesh.shape == {"tiles": 8, "samples": 1}
    assert [row[0].type for row in mesh.devices] == ["cpu"] * 8
    assert len(mesh_mod.available_devices("cpu")) == mesh_mod.CPU_DEVICES == 8
    mesh = make_mesh(2, 3, [f"meta:{i}" for i in range(7)])
    assert mesh.shape == {"tiles": 2, "samples": 3}
    assert [d.index for row in mesh.devices for d in row] == list(range(6))
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(3, 3, CPU8)


def test_uneven_pixels_padded(scene, camera):
    """npix not divisible by n_tile: padded pixels must not reach the
    image; it equals the single-device one (2 spp: bitwise)."""
    s = SETTINGS_2SPP.replace(width=37, height=13)  # 481 px
    img = render_sharded(scene, camera, s, make_mesh(8, 1, CPU8),
                         block_size=64, pix_chunk=1 << 8)
    assert img.shape == (13, 37, 3)
    assert np.isfinite(img).all()
    np.testing.assert_array_equal(img, _single(scene, camera, s))


def test_render_tile_devices_equals_single_device(scene, camera,
                                                  single_device_image_2spp):
    """render(tile_devices=N) on the CPU: a mesh of N virtual entries (at
    most 8), bitwise the single-device image at 2 spp; seed None draws
    one seed (both renders of one seed agree)."""
    for n in (3, 8, 16):
        img = wavefront.render(scene, camera, SETTINGS_2SPP, tile_devices=n,
                               block_size=64, device="cpu")
        np.testing.assert_array_equal(img, single_device_image_2spp)
    entropy = wavefront.render(scene, camera,
                               SETTINGS_2SPP.replace(seed=None),
                               tile_devices=2, device="cpu")
    assert np.isfinite(entropy).all()


def test_mesh_matches_jax_mesh(scene, camera):
    """The port's host-stepped mesh scheduler against the JAX package's
    on a (4, 2) mesh of its 8 virtual host devices."""
    from path_tracer_ai_tpu.config import RenderSettings as JSettings
    from path_tracer_ai_tpu.parallel import mesh as jmesh
    from path_tracer_ai_tpu.scene.camera import default_camera as jcamera
    from path_tracer_ai_tpu.scene.scene import (
        build_scene_from_arrays as jbuild_scene)

    s = dict(width=40, height=24, samples_per_pixel=4, max_bounces=2, seed=3)
    ref = np.asarray(jmesh.render_sharded_wavefront(
        jbuild_scene(*_arrays()), jcamera(), JSettings(**s),
        jmesh.make_mesh(4, 2), block_size=64, pix_chunk=1 << 9,
        compact_min_bucket=64))
    img = render_sharded_wavefront(scene, camera, RenderSettings(**s),
                                   make_mesh(4, 2, CPU8), block_size=64,
                                   pix_chunk=1 << 9, compact_min_bucket=64)
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse <= RMSE_REL * float(ref.mean()), (rmse, float(ref.mean()))


def test_cli_tile_devices(tmp_path, monkeypatch):
    """tests/test_mesh.py::test_cli_tile_devices on the port's CLI: 8
    virtual CPU entries with PT_PLATFORM=cpu."""
    from path_tracer_ai_tpu_torch.cli import main
    from path_tracer_ai_tpu_torch.io.png import read_png

    monkeypatch.setenv("PT_PLATFORM", "cpu")
    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 0 -1\nv 1 0 -1\nv 0 2 -1\nf 1 2 3\n")
    out = str(tmp_path / "tiled.png")
    rc = main(["-m", "tpu", "-w", "24", "-h", "12", "-s", "2", "-b", "2",
               "-i", str(obj), "-o", out, "--tile-devices", "8"])
    assert rc == 0
    assert read_png(out).shape == (12, 24, 3)


def test_kernel_launch_switches_to_the_tensors_card(monkeypatch):
    """cuda_build.launch calls a kernel's entry point with the tensors'
    card as the current device and that card's stream, and restores the
    current device: torch's own ops leave it unchanged, and the runtime
    launches on it (modelled here, where there is no card)."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch import cuda_build

    current = [torch.device("cuda", 0)]

    class Guard:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    def stream(dev=None):
        return SimpleNamespace(cuda_stream=f"stream of {dev or current[0]}")

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    seen = []

    def entry(*args):
        seen.append((current[0], args))
        return 0

    assert cuda_build.launch(entry, torch.device("cuda", 1), 7, 8) == 0
    assert seen == [(torch.device("cuda", 1), (7, 8, "stream of cuda:1"))]
    assert current == [torch.device("cuda", 0)]


def test_every_kernel_launches_through_the_device_switch():
    """No wrapper reads a stream itself: each kernel's launch goes through
    cuda_build.launch, so a tensor on any card launches on that card."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_closest,
        cuda_ctiles,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
    )
    from path_tracer_ai_tpu_torch import cuda_build

    wrappers = [cuda_ctiles.tile_sweep, cuda_ctiles.rcp_mismatches,
                cuda_anyhit.block_anyhit, cuda_closest.block_closest,
                cuda_sweep.closest_sweep, cuda_sweep.anyhit_sweep,
                cuda_items.item_sweep, cuda_kslots.kslot_sweep]
    for fn in wrappers:  # launch_instance launches its instance through launch
        src = inspect.getsource(fn)
        assert ("cuda_build.launch(" in src
                or "cuda_build.launch_instance(" in src), fn.__name__
    assert inspect.getsource(cuda_build.launch_instance).count(
        " launch(") == 2  # its two launches
    for mod in (cuda_ctiles, cuda_anyhit, cuda_closest, cuda_sweep,
                cuda_items, cuda_kslots):
        assert "current_stream" not in inspect.getsource(mod), mod.__name__


@pytest.mark.parametrize("render", ["wavefront", "fused"])
def test_shard_work_runs_on_its_device(scene, camera, monkeypatch, render):
    """Every bounce of a shard is issued with that shard's device current
    (mesh._on), the current device being per thread as a card's is: a
    (2, 2) mesh of four distinct entries, each driven by its own worker."""
    import collections
    import threading

    devs = [torch.device("cpu", i) for i in range(4)]
    local = threading.local()

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            self.prev = getattr(local, "current", None)
            local.current = self.dev

        def __exit__(self, *exc):
            local.current = self.prev

    issued = []
    if render == "wavefront":
        step = wavefront._Lanes.step

        def recorded(lanes, *args):
            issued.append(getattr(local, "current", None))
            return step(lanes, *args)

        monkeypatch.setattr(wavefront._Lanes, "step", recorded)
    else:
        trace = mesh_mod.tracer.trace_paths

        def recorded(*args, **kw):
            issued.append(getattr(local, "current", None))
            return trace(*args, **kw)

        monkeypatch.setattr(mesh_mod.tracer, "trace_paths", recorded)
    monkeypatch.setattr(mesh_mod, "_on", Guard)
    s = RenderSettings(width=16, height=8, samples_per_pixel=2,
                       max_bounces=2, seed=3)
    fn = render_sharded_wavefront if render == "wavefront" else render_sharded
    fn(scene, camera, s, make_mesh(2, 2, devs), block_size=64)
    per_chunk = devs * s.max_bounces if render == "wavefront" else devs
    assert collections.Counter(issued) == collections.Counter(per_chunk)
