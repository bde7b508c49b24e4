"""Unscented-transform (3DGUT) projection of 3D gaussians through nonlinear
camera models: distortion, fisheye, f-theta, lidar and rolling shutter.

Port of `gsplat_tpu/ops/projection_ut.py` (fully_fused_projection_ut
:73-250): the seven sigma points of each gaussian go through the camera
model (sensors/cameras.py); their weighted mean and covariance give the 2D
mean and covariance, then the blur and compensation, the PSD cull, the
opacity-aware extent and the eigenvalue-bounded radii.  Plain torch ops
differentiated by autograd.  The projection is used only to tile and sort
the eval3d path, or as the screen-space conic of the classic composite.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..sensors.cameras import (
    CameraModel,
    interpolate_shutter_pose,
    make_camera,
    viewmat_to_pose,
    world_point_to_image_point_shutter_pose,
)
from ..sensors.params import (
    FThetaCameraDistortionParameters,
    RollingShutterType,
    UnscentedTransformParameters,
)
from .math import quat_to_rotmat
from .projection import ALPHA_THRESHOLD, GAUSSIAN_EXTEND, MIN_COMPENSATION

Tensor = torch.Tensor


def _ut_weights(p: UnscentedTransformParameters, like: Tensor) -> Tuple[Tensor, Tensor]:
    """(w_mean [7], w_cov [7])."""
    D = 3.0
    lam = p.alpha * p.alpha * (D + p.kappa) - D
    w0m = lam / (D + lam)
    w0c = w0m + (1.0 - p.alpha * p.alpha + p.beta)
    wo = 1.0 / (2.0 * (D + lam))
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.tensor([w0m] + [wo] * 6, **kw), torch.tensor([w0c] + [wo] * 6, **kw)


def _sigma_points(means: Tensor, quats: Tensor, scales: Tensor,
                  p: UnscentedTransformParameters) -> Tensor:
    """[..., N, 7, 3]: the mean, then mean +/- sqrt(D + lam) s_i R[:, i]."""
    D = 3.0
    lam = p.alpha * p.alpha * (D + p.kappa) - D
    R = quat_to_rotmat(quats)
    deltas = (math.sqrt(D + lam) * R * scales[..., None, :]).transpose(-2, -1)
    m = means[..., None, :]
    return torch.cat([m, m + deltas, m - deltas], dim=-2)


def _weighted_sum(w: Tensor, x: Tensor, dim: int, fused: bool = True) -> Tensor:
    """sum_i w_i x_i along `dim` (w broadcasts against x), in index order.
    `fused` rounds each term's product and add once, as a fused multiply-add
    (XLA's dot, the JAX package's UT mean and covariance); otherwise the
    product and the add round apart (the JAX package's multiply-then-sum of
    the all-sigma-points mode).  The centre weight of the default UT is
    -99, so the rounding shows ~100x in the mean: the order is kept."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        wi, xi = w.select(dim, i), x.select(dim, i)
        if fused:
            acc = (acc.double() + wi.double() * xi.double()).to(x.dtype)
        else:
            acc = acc + wi * xi
    return acc


def _add_blur(cov: Tensor, eps2d: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(det of the blurred covariance, cov + eps2d I, compensation)."""
    det_orig = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    cov = cov + eps2d * torch.eye(2, dtype=cov.dtype, device=cov.device)
    det_blur = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    comp = torch.sqrt(torch.clamp(det_orig / det_blur, min=MIN_COMPENSATION * MIN_COMPENSATION))
    return det_blur, cov, comp


def fully_fused_projection_ut(
    means: Tensor,  # [..., N, 3]
    quats: Tensor,  # [..., N, 4] wxyz
    scales: Tensor,  # [..., N, 3]
    opacities: Optional[Tensor],  # [..., N]
    viewmats: Tensor,  # [..., C, 4, 4]
    Ks: Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    ut_params: Optional[UnscentedTransformParameters] = None,
    radial_coeffs: Optional[Tensor] = None,
    tangential_coeffs: Optional[Tensor] = None,
    thin_prism_coeffs: Optional[Tensor] = None,
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[Tensor] = None,  # [..., C, 4, 4]
    global_z_order: bool = True,
    camera: Optional[CameraModel] = None,
    lidar_coeffs=None,
    external_distortion=None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """UT projection: (radii int32 [..., C, N, 2], means2d [..., C, N, 2],
    depths [..., C, N], conics [..., C, N, 3], compensations or None)."""
    if ut_params is None:
        ut_params = UnscentedTransformParameters()
    N = means.shape[-2]
    C = viewmats.shape[-3]

    if camera is None:
        camera = make_camera(
            camera_model, width, height,
            focal_lengths=(None if camera_model == "ftheta"
                           else torch.stack([Ks[..., 0, 0], Ks[..., 1, 1]], dim=-1)),
            principal_points=Ks[..., :2, 2], radial_coeffs=radial_coeffs,
            tangential_coeffs=tangential_coeffs, thin_prism_coeffs=thin_prism_coeffs,
            ftheta_coeffs=ftheta_coeffs, shutter_type=rolling_shutter,
            lidar_coeffs=lidar_coeffs, external_distortion=external_distortion,
        )

    pose_start = viewmat_to_pose(viewmats)  # [..., C, 7]
    if rolling_shutter != RollingShutterType.GLOBAL:
        if viewmats_rs is None:
            raise ValueError("a rolling shutter needs viewmats_rs")
        pose_end = viewmat_to_pose(viewmats_rs)
        pose_mid = interpolate_shutter_pose(
            pose_start, pose_end, torch.full(pose_start.shape[:-1], 0.5, dtype=means.dtype,
                                             device=means.device))
        R_cam = quat_to_rotmat(pose_mid[..., 3:])
        t_cam = pose_mid[..., :3]
    else:
        # the same tensor: world_point_to_image_point_shutter_pose takes it as
        # the mark of a frame with one pose
        pose_end = pose_start
        R_cam = viewmats[..., :3, :3]
        t_cam = viewmats[..., :3, 3]

    # frustum cull on the transformed centre, written elementwise
    means_cam = (R_cam[..., :, None, :, :] * means[..., None, :, None, :]).sum(-1)
    means_cam = means_cam + t_cam[..., None, :]  # [..., C, N, 3]
    center_z = means_cam[..., 2]
    in_frustum = (center_z >= near_plane) & (center_z <= far_plane)

    # degenerate gaussians (zero quaternion, vanishing scale)
    eps = torch.finfo(means.dtype).eps
    valid_quat = (quats * quats).sum(-1) > eps
    valid_scale = (scales > eps).all(-1)
    in_frustum = in_frustum & valid_quat[..., None, :] & valid_scale[..., None, :]

    # sigma points through the camera model: [..., N, 7, 3] -> [..., C, N*7, 3]
    sp = _sigma_points(means, quats, scales, ut_params)
    B = tuple(means.shape[:-2])
    sp_flat = sp[..., None, :, :, :].expand(B + (C, N, 7, 3)).reshape(B + (C, N * 7, 3))
    pts2d_flat, valid_flat = world_point_to_image_point_shutter_pose(
        camera, sp_flat, pose_start, pose_end, margin_factor=ut_params.in_image_margin_factor)
    pts2d = pts2d_flat.reshape(B + (C, N, 7, 2))
    valid_pts = valid_flat.reshape(B + (C, N, 7))

    wm, wc = _ut_weights(ut_params, means)
    if ut_params.require_all_sigma_points_valid:
        # the first invalid sigma point ends the gaussian: cumulative validity
        cum_valid = torch.cumprod(valid_pts.to(means.dtype), dim=-1)
        valid_gaussian = cum_valid[..., -1] > 0.0
        wm_eff, wc_eff = wm * cum_valid, wc * cum_valid
    else:
        valid_gaussian = valid_pts.any(-1)
        wm_eff, wc_eff = wm, wc
    fused = not ut_params.require_all_sigma_points_valid
    mean2d = _weighted_sum(wm_eff[..., None], pts2d, -2, fused)
    d2 = pts2d - mean2d[..., None, :]
    outer = d2[..., :, None] * d2[..., None, :]
    cov2d = _weighted_sum(wc_eff[..., None, None], outer, -3, fused)

    valid_gaussian = valid_gaussian & in_frustum
    det, cov2d, compensations = _add_blur(cov2d, eps2d)
    valid_gaussian = valid_gaussian & (det > 0.0)

    # the negative UT centre weight can break positive definiteness: cull those
    c00, c01, c11 = cov2d[..., 0, 0], cov2d[..., 0, 1], cov2d[..., 1, 1]
    valid_gaussian = valid_gaussian & (c00 > 0.0) & (c11 > 0.0)

    # the conic inverts cov + 1e-6 I: finite gradients on singular,
    # already culled covariances
    b00, b11 = c00 + 1e-6, c11 + 1e-6
    inv_det = 1.0 / (b00 * b11 - c01 * c01)
    conics = torch.stack([b11 * inv_det, -c01 * inv_det, b00 * inv_det], dim=-1)

    extend = torch.full(valid_gaussian.shape, GAUSSIAN_EXTEND, dtype=means.dtype,
                        device=means.device)
    if opacities is not None:
        opacity = opacities[..., None, :] * compensations
        valid_gaussian = valid_gaussian & (opacity >= ALPHA_THRESHOLD)
        extend = torch.minimum(
            extend, torch.sqrt(2.0 * torch.log(torch.clamp(opacity / ALPHA_THRESHOLD, min=1.0))))

    # eigenvalue-bounded radii (arXiv:2402.00525 B.2)
    b = 0.5 * (c00 + c11)
    v1 = b + torch.sqrt(torch.clamp(b * b - det, min=0.01))
    r1 = extend * torch.sqrt(torch.clamp(v1, min=0.0))
    cov_diag = torch.stack([c00, c11], dim=-1)
    radius = torch.ceil(torch.minimum(
        extend[..., None] * torch.sqrt(torch.clamp(cov_diag, min=0.0)), r1[..., None]))

    valid_gaussian = valid_gaussian & (radius.amax(-1) > radius_clip)
    if camera_model != "lidar":  # a lidar culls against its field of view in the model
        size = torch.tensor([width, height], dtype=means.dtype, device=means.device)
        in_image = ((mean2d + radius > 0.0) & (mean2d - radius < size)).all(-1)
        valid_gaussian = valid_gaussian & in_image

    radii = torch.where(valid_gaussian[..., None], radius, 0.0).to(torch.int32)
    means2d = torch.where(valid_gaussian[..., None], mean2d, 0.0)
    depth = center_z if global_z_order else torch.linalg.norm(means_cam, dim=-1)
    depths = torch.where(valid_gaussian, depth, 0.0)
    conics = torch.where(valid_gaussian[..., None], conics, 0.0)
    compensations = torch.where(valid_gaussian, compensations, 0.0) if calc_compensations else None
    return radii, means2d, depths, conics, compensations
