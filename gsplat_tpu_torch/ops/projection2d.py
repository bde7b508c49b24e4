"""2DGS (surfel) projection: ray-transform matrices, normals, screen extents.

Port of `gsplat_tpu/ops/projection2d.py` (fully_fused_projection_2dgs) in
plain PyTorch ops, differentiated by autograd.  The surfel is the z = 0
plane of the gaussian's local frame; M maps homogeneous pixel coordinates
into that plane's (u, v) frame.  The 3x3 products are written as sums of
three elementwise terms, so no matrix product (and no TF32) touches them on
the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .math import quat_to_rotmat

GAUSSIAN_EXTEND_2D = 3.33
# |d| at or below this is treated like d == 0 (the surfel is culled): 1 / d
# would overflow float32 and hand autograd inf * 0 = NaN on a culled row
_D_EPS = 1e-30


def _matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for broadcastable [..., 3, 3] operands, elementwise in f32."""
    return sum(A[..., :, j : j + 1] * B[..., j : j + 1, :] for j in range(3))


def fully_fused_projection_2dgs(
    means: torch.Tensor,  # [..., N, 3]
    quats: torch.Tensor,  # [..., N, 4]
    scales: torch.Tensor,  # [..., N, 3] (activated; the z scale is unused)
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """Project surfels to (radii int32 [..., C, N, 2], means2d [..., C, N, 2],
    depths [..., C, N], ray_transforms M [..., C, N, 3, 3], camera-frame
    normals [..., C, N, 3] turned toward the camera)."""
    R_cw = viewmats[..., :3, :3]  # [..., C, 3, 3]
    t_cw = viewmats[..., :3, 3]  # [..., C, 3]
    means_c = (R_cw[..., :, None, :, :] * means[..., None, :, None, :]).sum(dim=-1)
    means_c = means_c + t_cw[..., None, :]  # [..., C, N, 3]

    RS_wl = quat_to_rotmat(quats) * scales[..., None, :]  # [..., N, 3, 3]
    RS_cl = _matmul3(R_cw[..., :, None, :, :], RS_wl[..., None, :, :, :])  # [..., C, N, 3, 3]

    # normals: the local z axis, turned toward the camera
    normals = RS_cl[..., 2]
    cos = -(normals * means_c).sum(dim=-1, keepdim=True)
    normals = normals * torch.where(cos > 0, 1.0, -1.0)

    # T = K [RS_:2 | mean_c]; M = T^T
    T_cl = torch.cat([RS_cl[..., :2], means_c[..., None]], dim=-1)
    T_sl = _matmul3(Ks[..., :, None, :, :], T_cl)
    M = T_sl.transpose(-1, -2)

    # screen extents from the homogeneous quadric
    test = torch.tensor([1.0, 1.0, -1.0], dtype=M.dtype, device=M.device)
    d = (M[..., 2] * M[..., 2] * test).sum(dim=-1, keepdim=True)
    valid = (d.abs() > eps) & (d.abs() > _D_EPS)
    f = torch.where(valid, test / torch.where(valid, d, 1.0), 0.0)[..., None]
    means2d = (M[..., :2] * M[..., 2:3] * f).sum(dim=-2)  # [..., C, N, 2]
    extents = torch.sqrt(torch.clamp(means2d**2 - (M[..., :2] * M[..., :2] * f).sum(dim=-2),
                                     min=1e-4))

    depths = means_c[..., 2]
    radius = torch.ceil(GAUSSIAN_EXTEND_2D * extents.detach())
    m2 = means2d.detach()
    ok = (
        valid[..., 0]
        & (depths > near_plane)
        & (depths < far_plane)
        & (m2[..., 0] + radius[..., 0] > 0)
        & (m2[..., 0] - radius[..., 0] < width)
        & (m2[..., 1] + radius[..., 1] > 0)
        & (m2[..., 1] - radius[..., 1] < height)
    )
    radii = torch.where(ok[..., None], radius, 0.0).to(torch.int32)
    return radii, means2d, depths, M.transpose(-1, -2), normals
