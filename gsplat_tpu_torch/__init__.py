"""gsplat_tpu_torch: the PyTorch / CUDA port of gsplat_tpu for NVIDIA Hopper.

It serves trained 3DGS scenes (rasterization, render_scene) and trains 3DGS
(trainer.Trainer, default or MCMC strategy) and 2DGS surfel models
(trainer_2dgs.Trainer2DGS, rasterization_2dgs), with hand-written CUDA
kernels under csrc/.  Kernels launch for CUDA tensors; their plain PyTorch
versions run for CPU tensors.  The JAX package `gsplat_tpu` stays the
reference; this package never imports it.
"""

from .rendering import rasterization, rasterization_2dgs, render_projected
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
    "rasterization_2dgs",
    "render_projected",
    "render_scene",
    "splats_from_numpy",
]
