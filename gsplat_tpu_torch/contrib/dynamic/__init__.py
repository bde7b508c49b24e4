"""G-SHARP dynamic-scene components (port of gsplat_tpu/contrib/dynamic)."""

from .deformation import DeformationTable, deform_network_apply, deform_network_init
from .hexplane import (
    grid_sample_2d,
    hexplane_apply,
    hexplane_init,
    spatial_planes,
    temporal_planes,
)
from .regulation import (
    hexplane_regularization,
    plane_smoothness,
    time_l1,
    time_smoothness,
)
from .strategy import DynamicStrategy

__all__ = [
    "DeformationTable",
    "DynamicStrategy",
    "deform_network_apply",
    "deform_network_init",
    "grid_sample_2d",
    "hexplane_apply",
    "hexplane_init",
    "hexplane_regularization",
    "plane_smoothness",
    "spatial_planes",
    "temporal_planes",
    "time_l1",
    "time_smoothness",
]
