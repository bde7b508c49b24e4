"""rasterize_to_pixels_eval3d: differentiable ray-based 3D rasterization.

Port of `gsplat_tpu/ops/rasterize_eval3d.py` (_core_e3d_fwd :72-126,
_core_e3d_bwd :129-178, rasterize_to_pixels_eval3d :184-249): the 3DGUT
renderer that evaluates each gaussian's response in 3D world space along
per-pixel rays, so that rays from any sensor model (distorted cameras, a
lidar) render.  The projection, UT or EWA, is used only for tiling and
sorting.  The forward runs:

  1. the AABB emission plan from the projected radii
     (ops/rasterize.py:make_emission_plan);
  2. the emission of every slot with its tile key, depth and gaussian id
     (kernel K8), one stable sort by (tile, depth), the per-tile spans and
     the gather of each sorted slot's F fields from its gaussian's record
     (kernel K9) (ops/rasterize.py:expand_sort_align);
  3. the composite along the rays (kernel K7a,
     ops/rasterize_eval3d_kernel.py).

The backward (`_RasterizeEval3DCore.backward`) runs the composite's
backward (K7b), which also gives the per-pixel ray gradients, then one
scatter back to emission order and the per-gaussian sums (K5)
(ops/rasterize.py:reduce_slot_grads).  The world-to-whitened transform
M = diag(1/s) R^T and the normals are built from quats and scales outside
the autograd Function, so their gradients flow by autograd.  Depth is the
sort key only and gets no gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .math import quat_to_rotmat
from .rasterize import (
    CH,
    EmissionPlan,
    _round_up,
    expand_sort_align,
    gaussian_records,
    make_emission_plan,
    reduce_slot_grads,
)
from .rasterize_eval3d_kernel import (
    TILE_3D,
    field_layout,
    rasterize_eval3d_bwd,
    rasterize_eval3d_fwd,
)


def iscl_rot_from_quat_scale(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """M = diag(1/s) R^T [..., 3, 3]: the world-to-whitened local transform
    (the port's own copy of gsplat_tpu/ops/rasterize_eval3d_ref.py:30-34)."""
    R = quat_to_rotmat(quats)
    return R.transpose(-1, -2) / scales[..., :, None]


class _RasterizeEval3DCore(torch.autograd.Function):
    """Emission, sort and the composite along rays, with the backward through
    K7b and K5.  Inputs are per gaussian, flattened over images ([E, ...]);
    culled rows (cnt == 0) are replaced by select before emission (zero
    fields, unit scales), so a NaN there reaches no slot and they get zero
    gradients."""

    @staticmethod
    def forward(ctx, xyzf, Mf, sclf, clf, nrf, opf, rays, depthf, plan: EmissionPlan, cap_total,
                tile_width, tile_height, n_images, use_hit_distance, return_normals):
        ok = (plan.cnt > 0)[:, None]
        rows = [xyzf, Mf, opf[:, None]]
        if use_hit_distance:
            rows.append(sclf)
        rows.append(clf)
        if return_normals:
            rows.append(nrf)
        fill = torch.zeros((1, sum(r.shape[1] for r in rows)), dtype=xyzf.dtype,
                           device=xyzf.device)
        if use_hit_distance:
            fill[:, 13:16] = 1.0  # culled rows take unit scales
        table = gaussian_records(rows, ok, fill)
        depthf = torch.where(ok[:, 0], depthf, 0.0)
        fields_s, bounds, order, _ = expand_sort_align(
            table, depthf, plan, cap_total, tile_width, tile_height, n_images
        )
        del table
        height, width = rays.shape[1], rays.shape[2]
        pix_out, t_final = rasterize_eval3d_fwd(
            fields_s, bounds, rays, n_images, tile_width, tile_height, width, height,
            use_hit_distance, return_normals,
        )
        if any(ctx.needs_input_grad[:7]):  # else no backward will run: keep nothing
            ctx.save_for_backward(fields_s, bounds, order, plan.cum_in, plan.n_slots, rays,
                                  pix_out, t_final)
        ctx.geometry = (n_images, tile_width, tile_height, width, height, use_hit_distance,
                        return_normals)
        ctx.n_channels = clf.shape[1]
        return pix_out, t_final

    @staticmethod
    def backward(ctx, v_pix, v_t):
        fields_s, bounds, order, cum_in, n_slots, rays, pix_out, t_final = ctx.saved_tensors
        n_images, tw, th, width, height, hit, normals = ctx.geometry
        D = ctx.n_channels
        v_slot, v_rays = rasterize_eval3d_bwd(
            fields_s, bounds, rays, n_images, tw, th, width, height, hit, normals,
            v_pix.contiguous(), v_t.contiguous(), pix_out, t_final,
        )
        vg = reduce_slot_grads(v_slot, order, cum_in, n_slots)  # [F, E]
        del v_slot
        _, color0, normal0, scale0 = field_layout(D, hit, normals)
        v_scl = vg[scale0 : scale0 + 3].t() if hit else None
        v_nr = vg[normal0 : normal0 + 3].t() if normals else None
        return (vg[0:3].t(), vg[3:12].t(), v_scl, vg[color0 : color0 + D].t(), v_nr, vg[12],
                v_rays, *([None] * 8))


def rasterize_to_pixels_eval3d(
    means: torch.Tensor,  # [N, 3] world
    quats: torch.Tensor,  # [N, 4] wxyz
    scales: torch.Tensor,  # [N, 3] (activated, > 0)
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    rays: torch.Tensor,  # [I, H, W, 6] world-space (origin, direction)
    image_width: int,
    image_height: int,
    radii: torch.Tensor,  # [I, N, 2] int32 (tiling, from the UT or EWA projection)
    depths: torch.Tensor,  # [I, N] (sort keys)
    means2d: torch.Tensor,  # [I, N, 2] projected centres (tiling only)
    isect_capacity: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    tile_size: int = TILE_3D,
    use_hit_distance: bool = False,
    return_normals: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
    """Render (colors [I, H, W, D], alphas [I, H, W, 1], normals [I, H, W, 3]
    or None, aux) by evaluating the gaussians in 3D along per-pixel rays;
    aux = {n_isects, isect_overflow, tiles_per_gauss}.

    With `use_hit_distance` the last channel is the hit distance along the
    ray in place of the input's.  Differentiable in means, quats, scales,
    colors, opacities, rays and backgrounds.  The emission holds
    round_up(isect_capacity + I*N, 512) slots, dummies included.
    """
    if tile_size != TILE_3D:
        raise ValueError(f"the eval3d rasterizer takes tile_size {TILE_3D}, got {tile_size}")
    I, N = colors.shape[0], colors.shape[1]
    E = I * N
    D = colors.shape[-1]
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    cap_total = _round_up(isect_capacity + E, CH)

    plan = make_emission_plan(means2d, radii, tile_size, tw, th, cap_total)
    M = iscl_rot_from_quat_scale(quats, scales).reshape(N, 9)
    if return_normals:
        normals = quat_to_rotmat(quats)[..., :, 2]  # [N, 3]
    else:
        normals = torch.zeros((N, 3), dtype=means.dtype, device=means.device)

    def per_image(x):
        return x[None].expand((I,) + tuple(x.shape)).reshape(E, x.shape[-1])

    pix_out, t_final = _RasterizeEval3DCore.apply(
        per_image(means), per_image(M), per_image(scales), colors.reshape(E, D),
        per_image(normals), opacities.reshape(E), rays.contiguous(), depths.detach().reshape(E),
        plan, cap_total, tw, th, I, use_hit_distance, return_normals,
    )
    render = pix_out[..., :D]
    render_n = pix_out[..., D : D + 3] if return_normals else None
    t_img = t_final[..., None]
    alphas = 1.0 - t_img
    if backgrounds is not None:
        render = render + t_img * backgrounds[:, None, None, :]
    aux = {
        "n_isects": plan.n_isects,
        "isect_overflow": plan.overflow,
        "tiles_per_gauss": plan.cnt.reshape(I, N),
    }
    return render, alphas, render_n, aux
