"""Per-view 3-D bilateral grids for colour correction during training.

Port of `gsplat_tpu/training/bilateral_grid.py:40-169`: a learnable
low-resolution grid of 3x4 colour affines per training view, sliced at each
pixel by (x, y, luminance) with trilinear weights (grid_sample's bilinear
weights with align_corners=True and border padding).

The interpolation factorises as

    A(p) = sum_l hat_l(z_p) * [B_y G_l B_x^T](p)

so the full-image slice is, per guidance level `l`, two small matrix
products (the separable bilinear resize of the level's (H_g, W_g, 12) map
onto the pixel lattice) and a multiply-add with the luminance hat weights,
as in the JAX package.  There is no `grid_sample`: its backward scatters the
grid gradient with atomics, which differ from run to run; matrix products
and elementwise sums give the same gradient every time.  The products run
in float32 (PyTorch's default keeps TF32 off for them).

The grids are channel-last, (N, L, H_g, W_g, 12), as the JAX package keeps
them, so they carry across unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

# BT.601 luma weights
_RGB2GRAY = (0.299, 0.587, 0.114)


def init_bilateral_grids(num: int, grid_x: int = 16, grid_y: int = 16, grid_w: int = 8,
                         device=None) -> torch.Tensor:
    """Identity-affine grids (num, grid_w, grid_y, grid_x, 12)."""
    ident = torch.tensor([1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0], dtype=torch.float32,
                         device=device)
    return ident.expand(num, grid_w, grid_y, grid_x, 12).contiguous()


def color_affine_transform(affine: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Per-pixel 3x4 affines (..., 12), rows of [M | t], applied to RGB
    values (..., 3), elementwise."""
    mats = affine.reshape(affine.shape[:-1] + (3, 4))
    return (mats[..., :3] * rgb[..., None, :]).sum(dim=-1) + mats[..., 3]


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared neighbour difference along the three grid axes of
    (N, L, H, W, 12) grids: per axis the sum of squares over the count of
    one grid's differences (channels included), summed over the axes and
    divided by N."""
    n = grids.shape[0]
    tv = torch.zeros((), dtype=torch.float32, device=grids.device)
    for axis in (1, 2, 3):
        size = grids.shape[axis]
        a = grids.narrow(axis, 1, size - 1)
        b = grids.narrow(axis, 0, size - 1)
        count = max(a.numel() // n, 1)
        tv = tv + torch.sum((a - b) ** 2) / count
    return tv / n


def _axis_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Linear-interpolation hat weights (..., size) of coordinates in
    [-1, 1] onto `size` grid points (align_corners=True), clamped to the
    border; at most two nonzeros a row."""
    u = (coords + 1.0) * 0.5 * (size - 1)
    u = torch.clamp(u, 0.0, float(size - 1))
    idx = torch.arange(size, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(u[..., None] - idx), min=0.0)


def rgb_to_guidance(rgb: torch.Tensor) -> torch.Tensor:
    """Gray-scale guidance in [-1, 1]."""
    gray = rgb[..., 0] * _RGB2GRAY[0] + rgb[..., 1] * _RGB2GRAY[1] + rgb[..., 2] * _RGB2GRAY[2]
    return gray * 2.0 - 1.0


def slice_image(grid: torch.Tensor, rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice one grid (L, H_g, W_g, 12) over an image (H, W, 3) in [0, 1],
    pixel centres at ((j + 0.5) / W, (i + 0.5) / H).  Returns (rgb_out
    (H, W, 3), affine (H, W, 12))."""
    L, Hg, Wg, _ = grid.shape
    H, W = rgb.shape[:2]
    dev = rgb.device
    ys = ((torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H) * 2.0 - 1.0
    xs = ((torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W) * 2.0 - 1.0
    by = _axis_weights(ys, Hg)  # (H, Hg)
    bx = _axis_weights(xs, Wg)  # (W, Wg)
    wz = _axis_weights(rgb_to_guidance(rgb), L)  # (H, W, L)
    affine = torch.zeros((H, W, 12), dtype=torch.float32, device=dev)
    for level in range(L):
        # the separable bilinear resize onto the pixel lattice: two products
        m = (by @ grid[level].reshape(Hg, Wg * 12)).reshape(H, Wg, 12)
        m = bx @ m  # (H, W, 12)
        affine = affine + m * wz[..., level, None]
    return color_affine_transform(affine, rgb), affine


def slice_points(grids: torch.Tensor, xy: torch.Tensor, rgb: torch.Tensor,
                 grid_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice per point from a batch of grids (N, L, H_g, W_g, 12): xy (P, 2)
    in [0, 1], rgb (P, 3), grid_idx (P,) int.  The point's grid is chosen by
    a one-hot contraction, as in the JAX package.  Returns (rgb_out (P, 3),
    affine (P, 12))."""
    N, L, Hg, Wg, _ = grids.shape
    P = xy.shape[0]
    bx = _axis_weights(xy[:, 0] * 2.0 - 1.0, Wg)  # (P, Wg)
    by = _axis_weights(xy[:, 1] * 2.0 - 1.0, Hg)  # (P, Hg)
    wz = _axis_weights(rgb_to_guidance(rgb), L)  # (P, L)
    onehot = (grid_idx[:, None] == torch.arange(N, dtype=grid_idx.dtype,
                                                device=grid_idx.device)).to(torch.float32)
    wyx = (by[:, :, None] * bx[:, None, :]).reshape(P, Hg * Wg)
    affine = torch.zeros((P, 12), dtype=torch.float32, device=xy.device)
    for level in range(L):
        sel = torch.einsum("pn,nkc->pkc", onehot, grids[:, level].reshape(N, Hg * Wg, 12))
        out = torch.einsum("pk,pkc->pc", wyx, sel)
        affine = affine + out * wz[:, level, None]
    return color_affine_transform(affine, rgb), affine
