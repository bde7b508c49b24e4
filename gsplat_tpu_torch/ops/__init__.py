from .contributing import (
    accumulate,
    rasterize_contributing_gaussian_ids,
    rasterize_num_contributing_gaussians,
    rasterize_to_indices_in_range,
    rasterize_top_contributing_gaussian_ids,
)
from .isect import (
    Isects,
    TileWorklist,
    build_tile_worklist,
    isect_offset_encode,
    isect_tiles,
)
from .math import (
    normalize,
    quat_inverse,
    quat_multiply,
    quat_rotate,
    quat_scale_to_covar_preci,
    quat_slerp,
    quat_to_rotmat,
    rotmat_to_quat,
    world_to_cam,
)
from .projection import (
    ALPHA_THRESHOLD,
    GAUSSIAN_EXTEND,
    MAX_ALPHA,
    MIN_COMPENSATION,
    TRANSMITTANCE_THRESHOLD,
    fully_fused_projection,
    proj,
)
from .projection_packed import compact_visible, fully_fused_projection_packed
from .projection_ut import fully_fused_projection_ut
from .projection2d import fully_fused_projection_2dgs
from .rasterize import rasterize_to_pixels
from .rasterize2d import rasterize_to_pixels_2dgs
from .rasterize_sparse import rasterize_to_pixels_sparse
from .rasterize2d_ref import rasterize_to_pixels_2dgs_ref
from .rasterize_ref import rasterize_to_pixels_ref
from .sh import eval_sh_bases, num_sh_bases, spherical_harmonics

__all__ = [
    "ALPHA_THRESHOLD",
    "accumulate",
    "rasterize_contributing_gaussian_ids",
    "rasterize_num_contributing_gaussians",
    "rasterize_to_indices_in_range",
    "rasterize_top_contributing_gaussian_ids",
    "GAUSSIAN_EXTEND",
    "Isects",
    "MAX_ALPHA",
    "MIN_COMPENSATION",
    "TRANSMITTANCE_THRESHOLD",
    "TileWorklist",
    "build_tile_worklist",
    "eval_sh_bases",
    "fully_fused_projection",
    "compact_visible",
    "fully_fused_projection_2dgs",
    "fully_fused_projection_packed",
    "fully_fused_projection_ut",
    "isect_offset_encode",
    "isect_tiles",
    "normalize",
    "num_sh_bases",
    "proj",
    "quat_inverse",
    "quat_multiply",
    "quat_rotate",
    "quat_scale_to_covar_preci",
    "quat_slerp",
    "quat_to_rotmat",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_pixels_sparse",
    "rasterize_to_pixels_2dgs_ref",
    "rasterize_to_pixels_ref",
    "rotmat_to_quat",
    "spherical_harmonics",
    "world_to_cam",
]
