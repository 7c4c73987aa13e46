"""Tests of the port that need an NVIDIA GPU (marker `gpu`).

They skip where torch sees no CUDA device. On the GPU machine, which has
no JAX (tests/conftest.py imports it):
    python -m pytest tests/test_torch_cuda.py -q --noconftest
The kernel must equal its plain version bit for bit (t) and exactly (tri).
"""

import numpy as np
import pytest
import torch

from path_tracer_ai_tpu_torch.accel import cuda_ctiles
from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
from path_tracer_ai_tpu_torch.scene.scene import blob_room_arrays

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("t_lanes,s", [(128, 256), (64, 128)])
def test_tile_sweep_kernel_matches_plain(cuda, rng, t_lanes, s):
    from types import SimpleNamespace

    arr = blob_room_arrays(4)
    acc = build_clusters(SimpleNamespace(v0=arr[0], v1=arr[1], v2=arr[2]),
                         cluster_size=s, device=cuda)
    nt = 256
    cid = rng.integers(0, acc.num_clusters, nt).astype(np.int32)
    v0 = acc.v0.cpu().numpy()
    o = v0[cid[:, None], rng.integers(0, s, (nt, t_lanes))].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-3
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(o.shape[0], np.inf, np.float32)
    tm[::7] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm), t_lanes)
    pack = cuda_ctiles.pack_tris(acc)
    before = cuda_ctiles.launches
    t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, t(cid))
    assert cuda_ctiles.launches == before + 1
    t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, t(cid))
    torch.cuda.synchronize()
    assert (tri_k != cuda_ctiles.I32_MAX).any()
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(tri_k, tri_p)


def test_wrapper_rejects_bad_inputs(cuda):
    pack = torch.zeros((2, 10, 128), device=cuda)
    rays = torch.zeros((4, 8, 64), device=cuda)
    cid = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_ctiles.tile_sweep(pack, rays, cid.long())
    with pytest.raises(ValueError):
        cuda_ctiles.tile_sweep(pack, rays[:, :, ::2], cid)
    with pytest.raises(ValueError):
        cuda_ctiles.tile_sweep(pack[:, :9], rays, cid)


def test_wavefront_equals_oracle_on_gpu(cuda):
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=3, device=cuda)
    s = RenderSettings(width=48, height=27, samples_per_pixel=2,
                       max_bounces=4, seed=3)
    before = cuda_ctiles.launches
    img_w = wavefront.render(scene, default_camera(cuda), s, wave_size=1 << 11,
                             device=cuda)
    assert cuda_ctiles.launches > before
    img_o = oracle.render(scene, default_camera(cuda), s, device=cuda)
    np.testing.assert_array_equal(img_w, img_o)
