"""External distortion: the bivariate windshield model of camera rays.

Port of `gsplat_tpu/sensors/external.py`.  The model warps a camera-frame
ray before the base camera model (forward) or after it (inverse):

    phi = asin(x / |r|),  theta = asin(y / |r|)
    x' = sin(P_h(phi, theta)),  y' = sin(P_v(phi, theta))
    z' = sqrt(1 - min(x'^2 + y'^2, 1)) * sign(z)

with P_h, P_v bivariate polynomials in the triangular Horner layout of
order 5 (21 coefficients, zero padded).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

MAX_ORDER = 5
MAX_COEFFS = 21  # (MAX_ORDER + 1)(MAX_ORDER + 2) / 2

_TRIANGULAR_ORDERS = {1: 0, 3: 1, 6: 2, 10: 3, 15: 4, 21: 5}


class ExternalDistortionModelParameters:
    """Base marker of external distortion models."""


def pad_coefficients_to_max_order(src: Sequence[float]) -> np.ndarray:
    """Zero-pad triangular coefficients to the order-5 layout: group k (the
    y^k term) holds order - k + 1 x-coefficients of its MAX_ORDER - k + 1
    slots."""
    src = np.asarray(src, np.float32).reshape(-1)
    if len(src) not in _TRIANGULAR_ORDERS:
        raise ValueError(
            f"invalid coefficient count {len(src)}; expected one of {sorted(_TRIANGULAR_ORDERS)}"
        )
    order = _TRIANGULAR_ORDERS[len(src)]
    dst = np.zeros(MAX_COEFFS, np.float32)
    so = do = 0
    for k in range(MAX_ORDER + 1):
        dsz = MAX_ORDER - k + 1
        ssz = order - k + 1 if k <= order else 0
        dst[do : do + ssz] = src[so : so + ssz]
        so += ssz
        do += dsz
    return dst


@dataclasses.dataclass(frozen=True)
class BivariateWindshieldModelParameters(ExternalDistortionModelParameters):
    """Forward and inverse bivariate polynomial pairs (triangular coefficients)."""

    horizontal_poly: Sequence[float]
    vertical_poly: Sequence[float]
    horizontal_poly_inverse: Sequence[float]
    vertical_poly_inverse: Sequence[float]

    MAX_ORDER = MAX_ORDER
    MAX_COEFFS = MAX_COEFFS

    def padded(self, device=None) -> Tuple[torch.Tensor, ...]:
        """(h, v, h_inv, v_inv) as float32 tensors in the order-5 layout."""
        return tuple(
            torch.from_numpy(pad_coefficients_to_max_order(p)).to(device)
            for p in (self.horizontal_poly, self.vertical_poly,
                      self.horizontal_poly_inverse, self.vertical_poly_inverse)
        )

    @classmethod
    def identity(cls) -> "BivariateWindshieldModelParameters":
        """P_h(phi, theta) = phi, P_v = theta: no warp."""
        return cls(horizontal_poly=(0.0, 1.0, 0.0), vertical_poly=(0.0, 0.0, 1.0),
                   horizontal_poly_inverse=(0.0, 1.0, 0.0),
                   vertical_poly_inverse=(0.0, 0.0, 1.0))


def eval_bivariate_poly(coeffs: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nested Horner over the order-5 triangular layout."""
    outer = []
    start = 0
    for inner_order in range(MAX_ORDER, -1, -1):
        r = torch.zeros_like(x)
        for idx in range(start + inner_order, start - 1, -1):
            r = r * x + coeffs[idx]
        outer.append(r)
        start += inner_order + 1
    result = torch.zeros_like(y)
    for idx in range(MAX_ORDER, -1, -1):
        result = result * y + outer[idx]
    return result


def distort_camera_ray(h_poly: torch.Tensor, v_poly: torch.Tensor, ray: torch.Tensor) -> torch.Tensor:
    """Warp camera-frame rays [..., 3] through the bivariate model; rays
    shorter than 1e-6 pass unchanged."""
    length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    safe = length[..., 0] >= 1e-6
    lin = torch.where(length < 1e-6, 1.0, length)[..., 0]
    phi = torch.arcsin(torch.clamp(ray[..., 0] / lin, -1.0, 1.0))
    theta = torch.arcsin(torch.clamp(ray[..., 1] / lin, -1.0, 1.0))
    x = torch.sin(eval_bivariate_poly(h_poly, phi, theta))
    y = torch.sin(eval_bivariate_poly(v_poly, phi, theta))
    z = torch.sqrt(1.0 - torch.clamp(x * x + y * y, max=1.0)) * torch.sign(
        torch.where(ray[..., 2] == 0, 1.0, ray[..., 2]))
    out = torch.stack([x, y, z], dim=-1)
    return torch.where(safe[..., None], out, ray)


def apply_external_distortion(params: BivariateWindshieldModelParameters, ray: torch.Tensor,
                              inverse: bool = False) -> torch.Tensor:
    """Distort camera rays forward, or undistort them with `inverse`."""
    h, v, hi, vi = params.padded(ray.device)
    if inverse:
        return distort_camera_ray(hi, vi, ray)
    return distort_camera_ray(h, v, ray)
