"""gsplat_tpu_torch: the PyTorch / CUDA port of gsplat_tpu for NVIDIA Hopper.

This slice serves a trained 3DGS scene: projection, SH, the tight tile plan
and the forward composite, with three hand-written CUDA kernels
(csrc/expand.cu: row and emission expansion; csrc/rasterize_fwd.cu: the
composite).  Kernels launch for CUDA tensors; their plain PyTorch versions
run for CPU tensors.  The JAX package `gsplat_tpu` stays the reference; this
package never imports it.
"""

from .rendering import rasterization, render_projected
from .scene import (
    GaussianInferenceScene,
    GaussianScene,
    Stage,
    load_checkpoint,
    render_scene,
    splats_from_numpy,
)

__all__ = [
    "GaussianInferenceScene",
    "GaussianScene",
    "Stage",
    "load_checkpoint",
    "rasterization",
    "render_projected",
    "render_scene",
    "splats_from_numpy",
]
