from .math import normalize, quat_scale_to_covar_preci, quat_to_rotmat
from .projection import (
    ALPHA_THRESHOLD,
    GAUSSIAN_EXTEND,
    MAX_ALPHA,
    MIN_COMPENSATION,
    TRANSMITTANCE_THRESHOLD,
    fully_fused_projection,
)
from .rasterize import rasterize_to_pixels
from .sh import eval_sh_bases, num_sh_bases, spherical_harmonics

__all__ = [
    "ALPHA_THRESHOLD",
    "GAUSSIAN_EXTEND",
    "MAX_ALPHA",
    "MIN_COMPENSATION",
    "TRANSMITTANCE_THRESHOLD",
    "eval_sh_bases",
    "fully_fused_projection",
    "normalize",
    "num_sh_bases",
    "quat_scale_to_covar_preci",
    "quat_to_rotmat",
    "rasterize_to_pixels",
    "spherical_harmonics",
]
