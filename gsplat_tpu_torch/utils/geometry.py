"""Image-space geometry: depth unprojection and surface normals.

Port of `gsplat_tpu/utils/geometry.py` (depth_to_points, depth_to_normal).
The 3x3 rotation of the ray directions is written elementwise, so no matrix
product (and no TF32) touches it on the card.
"""

from __future__ import annotations

import torch


def depth_to_points(
    depths: torch.Tensor,  # [..., H, W, 1]
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
    z_depth: bool = True,
) -> torch.Tensor:
    """Unproject a depth map to world-space points [..., H, W, 3]."""
    H, W = depths.shape[-3], depths.shape[-2]
    x = torch.arange(W, dtype=depths.dtype, device=depths.device)
    y = torch.arange(H, dtype=depths.dtype, device=depths.device)
    fx = Ks[..., 0, 0][..., None, None]
    fy = Ks[..., 1, 1][..., None, None]
    cx = Ks[..., 0, 2][..., None, None]
    cy = Ks[..., 1, 2][..., None, None]
    hw = depths.shape[:-1]
    dx = ((x[None, :] - cx + 0.5) / fx).expand(hw)  # [..., H, W]
    dy = ((y[:, None] - cy + 0.5) / fy).expand(hw)
    dirs = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)  # [..., H, W, 3]
    if not z_depth:
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    R = camtoworlds[..., None, None, :3, :3]  # [..., 1, 1, 3, 3]
    t = camtoworlds[..., :3, 3]
    world_dirs = (R * dirs[..., None, :]).sum(dim=-1)
    return t[..., None, None, :] + depths * world_dirs


def depth_to_normal(
    depths: torch.Tensor,  # [..., H, W, 1]
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
    z_depth: bool = True,
) -> torch.Tensor:
    """Surface normals [..., H, W, 3] from a depth map by cross products of
    neighbouring point differences; zero on the 1-pixel border."""
    pts = depth_to_points(depths, camtoworlds, Ks, z_depth=z_depth)
    dx = pts[..., 2:, 1:-1, :] - pts[..., :-2, 1:-1, :]
    dy = pts[..., 1:-1, 2:, :] - pts[..., 1:-1, :-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
