"""Packed (visibility-compacted) projection.

Port of `gsplat_tpu/ops/projection_packed.py:26-113` (compact_visible,
fully_fused_projection_packed): only the visible (radii > 0) gaussians, in
CSR-like form with per-entry camera and gaussian ids, front-compacted into a
caller-given `capacity` of slots by a stable sort of the visibility mask;
`nnz` and `overflow` report the true count and `indptr` [I+1] the rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from .projection import fully_fused_projection


def compact_visible(
    valid: torch.Tensor,  # [I, N] bool
    arrays,  # list of [I, N, ...] tensors to compact
    capacity: int,
):
    """Front-compact the entries where `valid` into `capacity` slots.

    Returns (camera_ids [cap], gaussian_ids [cap], compacted arrays,
    sel_mask [cap], nnz, overflow, indptr [I+1]).  Entries are camera-major,
    then by gaussian; an unused slot has ids -1 and a zeroed payload.
    """
    I, N = valid.shape
    flat = valid.reshape(-1)
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices[:capacity]
    sel_valid = flat[order]
    nnz = flat.sum().to(torch.int32)
    camera_ids = torch.where(sel_valid, torch.div(order, N, rounding_mode="floor"), -1)
    gaussian_ids = torch.where(sel_valid, order % N, -1)
    outs = []
    for a in arrays:
        af = a.reshape((I * N,) + tuple(a.shape[2:]))[order]
        mask = sel_valid.reshape((-1,) + (1,) * (af.dim() - 1))
        outs.append(torch.where(mask, af, torch.zeros_like(af)))
    counts = valid.sum(dim=1).to(torch.int32)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(torch.clamp(counts, max=capacity), 0,
                                                          dtype=torch.int32)])
    indptr = torch.clamp(indptr, max=capacity)
    return (camera_ids.to(torch.int32), gaussian_ids.to(torch.int32), outs, sel_valid, nnz,
            nnz > capacity, indptr)


def fully_fused_projection_packed(
    means: torch.Tensor,  # [N, 3]
    covars: Optional[torch.Tensor],
    quats: Optional[torch.Tensor],
    scales: Optional[torch.Tensor],
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    capacity: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    opacities: Optional[torch.Tensor] = None,
):
    """Packed projection: per-visible-splat tensors of length `capacity`,
    as a dict of camera_ids, gaussian_ids, radii, means2d, depths, conics,
    compensations (or None), valid, indptr, nnz and overflow."""
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, covars, quats, scales, viewmats, Ks, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip, calc_compensations=calc_compensations,
        camera_model=camera_model, opacities=opacities,
    )
    valid = (radii > 0).all(-1)  # [C, N]
    arrays = [radii, means2d, depths, conics]
    if compensations is not None:
        arrays.append(compensations)
    cam_ids, gs_ids, outs, sel_valid, nnz, overflow, indptr = compact_visible(
        valid, arrays, capacity
    )
    return dict(
        camera_ids=cam_ids,
        gaussian_ids=gs_ids,
        radii=outs[0],
        means2d=outs[1],
        depths=outs[2],
        conics=outs[3],
        compensations=outs[4] if compensations is not None else None,
        valid=sel_valid,
        indptr=indptr,
        nnz=nnz,
        overflow=overflow,
    )
