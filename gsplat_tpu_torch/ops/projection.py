"""Fused EWA projection of 3D Gaussians to 2D screen-space conics.

Port of `gsplat_tpu/ops/projection.py` (constants :29-33,
fully_fused_projection :171-269, proj :272) with the pinhole, ortho and
fisheye cameras.  Everything is elementwise f32 (no matrix products, so TF32 never
applies).  Conics are the upper triangle (a, b, c) of the inverse blurred
2D covariance; sigma(p) = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy.  Radii are
int32 [..., C, N, 2]; 0 marks a culled Gaussian.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .math import quat_to_rotmat, sym_mmT, triu_to_full

# The numeric contract shared with the JAX package and upstream gsplat.
ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.99
TRANSMITTANCE_THRESHOLD = 1e-4
MIN_COMPENSATION = 0.005
GAUSSIAN_EXTEND = 3.33
_TZ_EPS = 1e-6  # |depth| below this never renders (near planes are far larger)


def _covar_world(covars, quats, scales) -> torch.Tensor:
    """World covariance [..., N, 3, 3] from covars or (quats, scales)."""
    if covars is not None:
        return triu_to_full(covars) if covars.shape[-1] == 6 else covars
    if quats is None or scales is None:
        raise ValueError("pass covars, or quats and scales")
    R = quat_to_rotmat(quats)
    return sym_mmT(R * scales[..., None, :])


def _world_to_cam(means, covar_w, viewmats):
    """Camera-frame mean components (each [..., C, N]) and the six
    camera-frame covariance entries (s00, s01, s02, s11, s12, s22)."""
    R = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    mx, my, mz = (means[..., None, :, i] for i in range(3))  # [..., 1, N]
    Rc = [[R[..., i, j][..., None] for j in range(3)] for i in range(3)]
    tx = Rc[0][0] * mx + Rc[0][1] * my + Rc[0][2] * mz + t[..., 0:1]
    ty = Rc[1][0] * mx + Rc[1][1] * my + Rc[1][2] * mz + t[..., 1:2]
    tz = Rc[2][0] * mx + Rc[2][1] * my + Rc[2][2] * mz + t[..., 2:3]

    S = [[covar_w[..., None, :, i, j] for j in range(3)] for i in range(3)]

    def rowdot(i, j):  # (R S)[i, j]
        return Rc[i][0] * S[0][j] + Rc[i][1] * S[1][j] + Rc[i][2] * S[2][j]

    B = [[rowdot(i, j) for j in range(3)] for i in range(3)]

    def sym(i, l):  # (B R^T)[i, l]
        return B[i][0] * Rc[l][0] + B[i][1] * Rc[l][1] + B[i][2] * Rc[l][2]

    return (tx, ty, tz), (sym(0, 0), sym(0, 1), sym(0, 2), sym(1, 1), sym(1, 2), sym(2, 2))


def _intrinsics(Ks):
    return (Ks[..., 0, 0][..., None], Ks[..., 1, 1][..., None],
            Ks[..., 0, 2][..., None], Ks[..., 1, 2][..., None])


def _persp_proj(tx, ty, tz, S, Ks, width, height):
    """Perspective EWA projection, with the 0.3*tan_fov frustum clamp of
    tx/ty that the Jacobian uses."""
    s00, s01, s02, s11, s12, s22 = S
    fx, fy, cx, cy = _intrinsics(Ks)
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    # A gaussian on the camera plane (|tz| ~ 0) is culled by the near plane,
    # but 1/tz and tx/tz would hand autograd inf and NaN local derivatives,
    # and zero cotangents times those are NaN in the parameters.  Such rows
    # project with tz = 1 instead: finite values that nothing renders, and no
    # gradient through tz.
    tz = torch.where(tz.abs() < _TZ_EPS, 1.0, tz)
    txc = tz * torch.minimum(torch.maximum(tx / tz, -lim_x_neg), lim_x_pos)
    tyc = tz * torch.minimum(torch.maximum(ty / tz, -lim_y_neg), lim_y_pos)

    rz = 1.0 / tz
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * txc * rz2
    j11 = fy * rz
    j12 = -fy * tyc * rz2

    c00 = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    c01 = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c11 = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    return (fx * tx * rz + cx, fy * ty * rz + cy), (c00, c01, c11)


def _ortho_proj(tx, ty, tz, S, Ks, width, height):
    s00, s01, s11 = S[0], S[1], S[3]
    fx, fy, cx, cy = _intrinsics(Ks)
    return (fx * tx + cx, fy * ty + cy), (fx * fx * s00, fx * fy * s01, fy * fy * s11)


def _fisheye_proj(tx, ty, tz, S, Ks, width, height):
    """Equidistant fisheye projection with its full 2x3 Jacobian."""
    s00, s01, s02, s11, s12, s22 = S
    fx, fy, cx, cy = _intrinsics(Ks)
    eps = 1e-7
    # the clamp keeps sqrt's derivative finite for a mean on the optical axis
    xy_len = torch.sqrt(torch.clamp(tx * tx + ty * ty, min=1e-24)) + eps
    theta = torch.atan2(xy_len, tz + eps)
    m2x = tx * fx * theta / xy_len + cx
    m2y = ty * fy * theta / xy_len + cy

    x2 = tx * tx + eps
    y2 = ty * ty
    xy = tx * ty
    x2y2 = x2 + y2
    x2y2z2_inv = 1.0 / (x2y2 + tz * tz)
    b = torch.atan2(xy_len, tz) / xy_len / x2y2
    a = tz * x2y2z2_inv / x2y2
    j00 = fx * (x2 * a + y2 * b)
    j01 = fx * xy * (a - b)
    j02 = -fx * tx * x2y2z2_inv
    j10 = fy * xy * (a - b)
    j11 = fy * (y2 * a + x2 * b)
    j12 = -fy * ty * x2y2z2_inv

    r0 = (j00 * s00 + j01 * s01 + j02 * s02,
          j00 * s01 + j01 * s11 + j02 * s12,
          j00 * s02 + j01 * s12 + j02 * s22)
    r1 = (j10 * s00 + j11 * s01 + j12 * s02,
          j10 * s01 + j11 * s11 + j12 * s12,
          j10 * s02 + j11 * s12 + j12 * s22)
    c00 = r0[0] * j00 + r0[1] * j01 + r0[2] * j02
    c01 = r0[0] * j10 + r0[1] * j11 + r0[2] * j12
    c11 = r1[0] * j10 + r1[1] * j11 + r1[2] * j12
    return (m2x, m2y), (c00, c01, c11)


_CAMERAS = {"pinhole": _persp_proj, "ortho": _ortho_proj, "fisheye": _fisheye_proj}


def fully_fused_projection(
    means: torch.Tensor,  # [..., N, 3]
    covars: Optional[torch.Tensor],  # [..., N, 6] or [..., N, 3, 3] or None
    quats: Optional[torch.Tensor],  # [..., N, 4] or None
    scales: Optional[torch.Tensor],  # [..., N, 3] or None
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    opacities: Optional[torch.Tensor] = None,  # [..., N]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Project 3D Gaussians to per-camera 2D conics, depths and pixel radii.

    Returns (radii int32 [..., C, N, 2], means2d [..., C, N, 2],
    depths [..., C, N], conics [..., C, N, 3], compensations or None).
    Culling: depth in [near_plane, far_plane], the opacity-aware extend
    (arXiv:2402.00525 B.2), `radius_clip` when both axes are small, and the
    strict frustum test.
    """
    if camera_model == "lidar":
        # the EWA projection has no lidar model, as in the JAX package
        raise ValueError(
            "unsupported camera_model: 'lidar' (render a lidar through "
            "rasterization(..., camera_model='lidar', with_ut=True, with_eval3d=True))"
        )
    if camera_model not in _CAMERAS:
        raise ValueError(f"unsupported camera_model: {camera_model!r}")
    covar_w = _covar_world(covars, quats, scales)
    (tx, ty, tz), S = _world_to_cam(means, covar_w, viewmats)
    (m2x, m2y), (c00, c01, c11) = _CAMERAS[camera_model](tx, ty, tz, S, Ks, width, height)

    det_orig = c00 * c11 - c01 * c01
    b00 = c00 + eps2d
    b11 = c11 + eps2d
    det = torch.clamp(b00 * b11 - c01 * c01, min=1e-10)

    compensations = None
    if calc_compensations:
        compensations = torch.sqrt(
            torch.clamp(det_orig / det, min=MIN_COMPENSATION * MIN_COMPENSATION)
        )

    inv_det = 1.0 / det
    conics = torch.stack([b11 * inv_det, -c01 * inv_det, b00 * inv_det], dim=-1)
    means2d = torch.stack([m2x, m2y], dim=-1)

    extend = torch.full_like(tz, GAUSSIAN_EXTEND)
    valid = (tz >= near_plane) & (tz <= far_plane)
    if opacities is not None:
        op = opacities * compensations if compensations is not None else (
            opacities[..., None, :].expand(tz.shape)
        )
        valid &= op >= ALPHA_THRESHOLD
        extend = torch.clamp(
            torch.sqrt(2.0 * torch.log(torch.clamp(op, min=ALPHA_THRESHOLD) / ALPHA_THRESHOLD)),
            max=GAUSSIAN_EXTEND,
        )

    radius_x = torch.ceil(extend * torch.sqrt(torch.clamp(b00, min=0.0)))
    radius_y = torch.ceil(extend * torch.sqrt(torch.clamp(b11, min=0.0)))

    valid &= ~((radius_x <= radius_clip) & (radius_y <= radius_clip))
    valid &= ~(
        (m2x + radius_x <= 0)
        | (m2x - radius_x >= width)
        | (m2y + radius_y <= 0)
        | (m2y - radius_y >= height)
    )
    radii = torch.where(
        valid[..., None], torch.stack([radius_x, radius_y], dim=-1), 0.0
    ).to(torch.int32)
    return radii, means2d, tz, conics, compensations


def proj(
    means: torch.Tensor,  # [..., C, N, 3] camera-frame means
    covars: torch.Tensor,  # [..., C, N, 3, 3] camera-frame covariances
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    camera_model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The camera projection alone: (means2d [..., C, N, 2], covars2d
    [..., C, N, 2, 2]), through the same camera functions as
    fully_fused_projection (a pinhole mean within 1e-6 of the camera plane
    projects with depth 1 there, as in that function)."""
    if camera_model not in _CAMERAS:
        raise ValueError(f"unsupported camera_model: {camera_model!r}")
    tx, ty, tz = means.unbind(-1)
    S = (covars[..., 0, 0], covars[..., 0, 1], covars[..., 0, 2],
         covars[..., 1, 1], covars[..., 1, 2], covars[..., 2, 2])
    (m2x, m2y), (c00, c01, c11) = _CAMERAS[camera_model](tx, ty, tz, S, Ks, width, height)
    means2d = torch.stack([m2x, m2y], dim=-1)
    covars2d = torch.stack(
        [torch.stack([c00, c01], dim=-1), torch.stack([c01, c11], dim=-1)], dim=-2
    )
    return means2d, covars2d
