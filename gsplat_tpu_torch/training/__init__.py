from .bilateral_grid import (
    color_affine_transform,
    init_bilateral_grids,
    slice_image as bilateral_slice_image,
    slice_points as bilateral_slice_points,
    total_variation_loss,
)
from .metrics import load_lpips_weights, lpips, lpips_proxy, psnr
from .pose import (
    apply_appearance,
    apply_pose_deltas,
    init_appearance,
    init_pose_deltas,
    invert_se3,
    rotation_6d_to_matrix,
)
from .ppisp import apply_ppisp, init_ppisp, ppisp_regularization
from .schedulers import exponential_lr, two_stage_lr

__all__ = [
    "init_bilateral_grids",
    "bilateral_slice_image",
    "bilateral_slice_points",
    "color_affine_transform",
    "total_variation_loss",
    "exponential_lr",
    "two_stage_lr",
    "psnr",
    "lpips",
    "lpips_proxy",
    "init_ppisp",
    "apply_ppisp",
    "ppisp_regularization",
    "load_lpips_weights",
    "init_pose_deltas",
    "apply_pose_deltas",
    "rotation_6d_to_matrix",
    "init_appearance",
    "apply_appearance",
]
