"""gsplat_tpu_torch: the PyTorch / CUDA port of gsplat_tpu for NVIDIA Hopper.

It serves trained 3DGS scenes (rasterization, render_scene), trains 3DGS
(trainer.Trainer, default or MCMC strategy, with the JAX trainer's pose,
appearance, bilateral-grid and PPISP add-ons) and 2DGS surfel models
(trainer_2dgs.Trainer2DGS, rasterization_2dgs), and compresses a scene into
PNG planes (PngCompression), with hand-written CUDA
kernels under csrc/.  Kernels launch for CUDA tensors; their plain PyTorch
versions run for CPU tensors.  The JAX package `gsplat_tpu` stays the
reference; this package never imports it.  The export list is the JAX
package's (gsplat_tpu/__init__.py); the port's own entry points
`splats_from_numpy`, `load_checkpoint` and `render_projected` are importable
from here besides; the feature probes (`has_3dgs()` etc.)
return True, as there: every subsystem is built in.
"""

from . import ops, sensors
from .compression import PngCompression
from .color_correct import color_correct_affine, color_correct_quadratic
from .exporter import export_splats, load_ply_to_splats
from .losses import (
    depth_l1_loss,
    fused_gaussian_losses,
    gaussian_density_reg,
    gaussian_scale_reg,
    gaussian_z_scale_reg,
    l1_loss,
    lidar_background_loss,
    lidar_distance_loss,
    lidar_intensity_loss,
    lidar_raydrop_loss,
    mse_loss,
    opacity_reg_loss,
    out_of_bound_loss,
    scale_reg_loss,
    ssim_loss,
    total_variation_loss,
)
from .ops import (
    accumulate,
    compact_visible,
    fully_fused_projection,
    fully_fused_projection_2dgs,
    fully_fused_projection_packed,
    fully_fused_projection_ut,
    isect_offset_encode,
    isect_tiles,
    proj,
    quat_scale_to_covar_preci,
    rasterize_contributing_gaussian_ids,
    rasterize_num_contributing_gaussians,
    rasterize_to_indices_in_range,
    rasterize_to_pixels_sparse,
    rasterize_top_contributing_gaussian_ids,
    spherical_harmonics,
    world_to_cam,
)
from .ops.contributing import rasterize_to_indices_in_range_2dgs
from .ops.rasterize import rasterize_to_pixels
from .ops.rasterize2d import rasterize_to_pixels_2dgs
from .ops.rasterize_eval3d import rasterize_to_pixels_eval3d
from .optimizers.adam import adam_init, adam_update, selective_adam_update
from .rendering import rasterization, rasterization_2dgs, render_projected
from .scene import (
    GaussianInferenceScene,
    GaussianScene,
    Scene,
    Stage,
    load_checkpoint,
    render_scene,
    splats_from_numpy,
)
from .sensors import (
    FThetaCameraDistortionParameters,
    FThetaPolynomialType,
    RollingShutterType,
    UnscentedTransformParameters,
)
from .sensors.lidars import LidarModel, SpinningDirection, make_lidar
from .strategy import DefaultStrategy, MCMCStrategy, Strategy


# Feature probes (upstream gsplat/cuda/_wrapper.py:268-294): every subsystem
# is built in, so each returns True.
def has_3dgs() -> bool:
    return True


def has_2dgs() -> bool:
    return True


def has_3dgut() -> bool:
    return True


def has_adam() -> bool:
    return True


def has_camera_wrappers() -> bool:
    return True


def has_losses() -> bool:
    return True


def has_reloc() -> bool:
    return True


__all__ = [
    "DefaultStrategy",
    "FThetaCameraDistortionParameters",
    "FThetaPolynomialType",
    "GaussianInferenceScene",
    "GaussianScene",
    "LidarModel",
    "MCMCStrategy",
    "PngCompression",
    "RollingShutterType",
    "Scene",
    "SpinningDirection",
    "Stage",
    "Strategy",
    "UnscentedTransformParameters",
    "accumulate",
    "adam_init",
    "adam_update",
    "color_correct_affine",
    "color_correct_quadratic",
    "compact_visible",
    "depth_l1_loss",
    "export_splats",
    "fully_fused_projection",
    "fully_fused_projection_2dgs",
    "fully_fused_projection_packed",
    "fully_fused_projection_ut",
    "fused_gaussian_losses",
    "gaussian_density_reg",
    "gaussian_scale_reg",
    "gaussian_z_scale_reg",
    "has_2dgs",
    "has_3dgs",
    "has_3dgut",
    "has_adam",
    "has_camera_wrappers",
    "has_losses",
    "has_reloc",
    "isect_offset_encode",
    "isect_tiles",
    "l1_loss",
    "lidar_background_loss",
    "lidar_distance_loss",
    "lidar_intensity_loss",
    "lidar_raydrop_loss",
    "load_ply_to_splats",
    "make_lidar",
    "mse_loss",
    "opacity_reg_loss",
    "ops",
    "out_of_bound_loss",
    "proj",
    "quat_scale_to_covar_preci",
    "rasterization",
    "rasterization_2dgs",
    "rasterize_contributing_gaussian_ids",
    "rasterize_num_contributing_gaussians",
    "rasterize_to_indices_in_range",
    "rasterize_to_indices_in_range_2dgs",
    "rasterize_to_pixels",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_pixels_eval3d",
    "rasterize_to_pixels_sparse",
    "rasterize_top_contributing_gaussian_ids",
    "render_scene",
    "scale_reg_loss",
    "selective_adam_update",
    "sensors",
    "spherical_harmonics",
    "ssim_loss",
    "total_variation_loss",
    "world_to_cam",
]
