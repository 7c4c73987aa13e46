"""path_tracer_ai_tpu_torch — the PyTorch/CUDA port of path_tracer_ai_tpu.

The JAX package beside this one is the reference; this package keeps its
module layout (`core/`, `scene/`, `io/`, `engine/`, `accel/`) so each module
has an obvious counterpart. It imports torch, numpy and the standard library
only. Entry points run on `cuda` unless the caller passes `device="cpu"`.

Plain tensor code is eager PyTorch. The closest-hit tile sweep
(`accel.cuda_ctiles.tile_sweep`) is a hand-written CUDA kernel for sm_90a
(`csrc/ctiles_sweep.cu`); on CPU tensors it runs its plain PyTorch version.
"""

from path_tracer_ai_tpu_torch.config import RenderSettings
from path_tracer_ai_tpu_torch.core.types import (
    MATERIAL_DIELECTRIC,
    MATERIAL_DIFFUSE,
    MATERIAL_SPECULAR,
    Lights,
    MaterialTable,
    SceneData,
    TrianglesSoA,
)

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "TrianglesSoA",
    "MaterialTable",
    "Lights",
    "SceneData",
    "MATERIAL_DIFFUSE",
    "MATERIAL_SPECULAR",
    "MATERIAL_DIELECTRIC",
]
