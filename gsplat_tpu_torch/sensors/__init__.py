"""Sensor models: pinhole, OpenCV, orthographic, fisheye and f-theta cameras
with rolling shutter, the windshield distortion and the spinning lidar, as
plain functions on tensors over parameter records (port of
`gsplat_tpu/sensors/`)."""

from .cameras import (
    CameraModel,
    camera_ray_to_image_point,
    generate_rays,
    image_point_to_camera_ray,
    image_point_to_world_ray_shutter_pose,
    interpolate_shutter_pose,
    make_camera,
    pose_camera_ray_to_world_ray,
    pose_world_points_to_camera_ray,
    shutter_relative_frame_time,
    viewmat_to_pose,
    world_point_to_image_point_shutter_pose,
)
from .external import (
    BivariateWindshieldModelParameters,
    ExternalDistortionModelParameters,
    apply_external_distortion,
)
from .params import (
    CameraLinearParams,
    FThetaCameraDistortionParameters,
    FThetaPolynomialType,
    RollingShutterType,
    UnscentedTransformParameters,
)

__all__ = [
    "BivariateWindshieldModelParameters",
    "CameraLinearParams",
    "ExternalDistortionModelParameters",
    "apply_external_distortion",
    "CameraModel",
    "FThetaCameraDistortionParameters",
    "FThetaPolynomialType",
    "RollingShutterType",
    "UnscentedTransformParameters",
    "camera_ray_to_image_point",
    "generate_rays",
    "image_point_to_camera_ray",
    "image_point_to_world_ray_shutter_pose",
    "interpolate_shutter_pose",
    "make_camera",
    "pose_camera_ray_to_world_ray",
    "pose_world_points_to_camera_ray",
    "shutter_relative_frame_time",
    "viewmat_to_pose",
    "world_point_to_image_point_shutter_pose",
]
