"""Sensor parameter types.

Port of `gsplat_tpu/sensors/params.py`: the rolling-shutter and f-theta
polynomial enums, the f-theta distortion record, the unscented-transform
parameters (alpha 0.1, beta 2, kappa 0, in-image margin 0.1) and the
camera models' fixed Newton iteration counts.  Plain Python records; no
tensor lives here.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Sequence


class RollingShutterType(IntEnum):
    ROLLING_TOP_TO_BOTTOM = 0
    ROLLING_LEFT_TO_RIGHT = 1
    ROLLING_BOTTOM_TO_TOP = 2
    ROLLING_RIGHT_TO_LEFT = 3
    GLOBAL = 4


class FThetaPolynomialType(IntEnum):
    PIXELDIST_TO_ANGLE = 0
    ANGLE_TO_PIXELDIST = 1


@dataclasses.dataclass(frozen=True)
class FThetaCameraDistortionParameters:
    """F-theta polynomial camera distortion.

    One of the two polynomials is the calibrated reference; the other
    direction is found by Newton inversion of it.
    """

    reference_poly: FThetaPolynomialType
    pixeldist_to_angle_poly: Sequence[float]  # 6 coefficients, full polynomial
    angle_to_pixeldist_poly: Sequence[float]  # 6 coefficients, full polynomial
    max_angle: float
    # linear transform A = [[c, d], [e, 1]] of the distorted coordinates
    linear_cde: Sequence[float] = (1.0, 0.0, 0.0)

    def __post_init__(self):
        if len(self.pixeldist_to_angle_poly) != 6 or len(self.angle_to_pixeldist_poly) != 6:
            raise ValueError("f-theta polynomials take 6 coefficients each")
        if len(self.linear_cde) != 3:
            raise ValueError("linear_cde takes 3 values (c, d, e)")


@dataclasses.dataclass(frozen=True)
class UnscentedTransformParameters:
    """Sigma-point parameters (Wan and van der Merwe 2000)."""

    alpha: float = 0.1
    beta: float = 2.0
    kappa: float = 0.0
    in_image_margin_factor: float = 0.1
    require_all_sigma_points_valid: bool = False

    def __post_init__(self):
        if not self.alpha * self.alpha * (3 + self.kappa) > 0.0:
            raise ValueError("UT parameters invalid: alpha^2 * (D + kappa) must be > 0")


@dataclasses.dataclass(frozen=True)
class CameraLinearParams:
    """Fixed iteration counts and thresholds of the inverse camera models."""

    max_undistortion_iterations: int = 5
    newton_iterations: int = 20
    min_2d_norm: float = 1e-6
