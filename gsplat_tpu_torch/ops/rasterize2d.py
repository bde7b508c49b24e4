"""rasterize_to_pixels_2dgs: the differentiable surfel rasterization op.

Port of `gsplat_tpu/ops/rasterize2d.py` (_core2d_fwd :66-105, _core2d_bwd
:108-151, rasterize_to_pixels_2dgs :157-220).  The forward runs:

  1. the AABB emission plan (ops/rasterize.py:make_emission_plan);
  2. the emission of every slot with its tile key, depth and 15 + D fields
     (kernel K8, ops/gather_kernel.py:expand_emission_aabb);
  3. one stable sort by (tile, depth), the row gather into sorted order
     (kernel K9, ops/gather_kernel.py:align_rows) and per-tile spans;
  4. the surfel composite (kernel K6a, ops/rasterize2d_kernel.py).

The backward (`_Rasterize2DCore.backward`) runs the composite's backward
(K6b), one scatter back to emission order and the per-gaussian sums (K5,
ops/segsum_kernel.py), then forms the `densify` carrier's gradient
(v_u.z * w.z, v_v.z * w.z) from the ray transform's (rasterize2d.py:139-142),
the screen gradient of upstream's DefaultStrategy(key_for_gradient=
"gradient_2dgs").  Depth is the sort key only and gets no gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .rasterize import (
    CH,
    EmissionPlan,
    _round_up,
    expand_sort_align,
    make_emission_plan,
    reduce_slot_grads,
)
from .rasterize2d_kernel import TILE_2D, rasterize2d_bwd, rasterize2d_fwd


class _Rasterize2DCore(torch.autograd.Function):
    """Emission, sort and surfel composite, with the backward through K6b
    and K5.  Inputs are per gaussian, flattened over images ([E, ...]);
    culled rows (cnt == 0) are zeroed by select before emission, so a NaN
    there reaches no slot and they get zero gradients."""

    @staticmethod
    def forward(ctx, m2f, Mf, clf, nrf, opf, densify, depthf, plan: EmissionPlan,
                cap_total, tile_width, tile_height, n_images, width, height):
        ok = (plan.cnt > 0)[:, None]
        Mf = torch.where(ok, Mf, 0.0)
        table = torch.where(ok, torch.cat([m2f, Mf, opf[:, None], clf, nrf], dim=1), 0.0)
        depthf = torch.where(ok[:, 0], depthf, 0.0)
        fields_s, bounds, order, _ = expand_sort_align(
            table.t().contiguous(), depthf, plan, cap_total, tile_width, tile_height, n_images
        )
        del table
        pix_out, t_final, med_slot = rasterize2d_fwd(
            fields_s, bounds, n_images, tile_width, tile_height, width, height
        )
        ctx.mark_non_differentiable(med_slot)
        if any(ctx.needs_input_grad[:6]):  # else no backward will run: keep nothing
            ctx.save_for_backward(fields_s, bounds, order, plan.cum_in, plan.n_slots, Mf[:, 8],
                                  pix_out, t_final, med_slot)
        ctx.geometry = (n_images, tile_width, tile_height, width, height)
        return pix_out, t_final, med_slot

    @staticmethod
    def backward(ctx, v_pix, v_t, _v_med_slot):
        fields_s, bounds, order, cum_in, n_slots, w_z, pix_out, t_final, med_slot = (
            ctx.saved_tensors
        )
        D = fields_s.shape[0] - 15
        v_slot = rasterize2d_bwd(
            fields_s, bounds, *ctx.geometry, v_pix.contiguous(), v_t.contiguous(), pix_out,
            t_final, med_slot,
        )
        vg = reduce_slot_grads(v_slot, order, cum_in, n_slots)  # [15+D, E]
        v_M = vg[2:11].t()
        v_densify = torch.stack([vg[4] * w_z, vg[7] * w_z], dim=1)
        return (vg[0:2].t(), v_M, vg[12 : 12 + D].t(), vg[12 + D : 15 + D].t(), vg[11],
                v_densify, *([None] * 8))


def rasterize_to_pixels_2dgs(
    means2d: torch.Tensor,  # [I, N, 2]
    ray_transforms: torch.Tensor,  # [I, N, 3, 3] or [I, N, 9]
    colors: torch.Tensor,  # [I, N, D], depth as the last channel
    normals: torch.Tensor,  # [I, N, 3]
    opacities: torch.Tensor,  # [I, N]
    image_width: int,
    image_height: int,
    radii: torch.Tensor,  # [I, N, 2] int32
    depths: torch.Tensor,  # [I, N]
    isect_capacity: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    tile_size: int = TILE_2D,
    densify: Optional[torch.Tensor] = None,  # [I, N, 2] screen-gradient carrier
) -> Tuple[torch.Tensor, ...]:
    """Rasterize surfels; returns (colors [I, H, W, D], alphas [I, H, W, 1],
    normals [I, H, W, 3], distortion [I, H, W, 1], median depth [I, H, W, 1],
    aux) with aux = {n_isects, isect_overflow, tiles_per_gauss}.

    Differentiable in means2d, ray_transforms, colors, normals, opacities,
    backgrounds and `densify` (value unused; its gradient is the screen
    gradient the default strategy reads).  The emission holds
    round_up(isect_capacity + I*N, 512) slots, dummies included.
    """
    if tile_size != TILE_2D:
        raise ValueError(f"the 2DGS rasterizer takes tile_size {TILE_2D}, got {tile_size}")
    I, N = means2d.shape[0], means2d.shape[1]
    E = I * N
    D = colors.shape[-1]
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    cap_total = _round_up(isect_capacity + E, CH)

    plan = make_emission_plan(means2d, radii, tile_size, tw, th, cap_total)
    if densify is None:
        densify = torch.zeros((I, N, 2), dtype=means2d.dtype, device=means2d.device)
    pix_out, t_final, _ = _Rasterize2DCore.apply(
        means2d.reshape(E, 2), ray_transforms.reshape(E, 9), colors.reshape(E, D),
        normals.reshape(E, 3), opacities.reshape(E), densify.reshape(E, 2),
        depths.detach().reshape(E), plan, cap_total, tw, th, I, image_width, image_height,
    )
    render = pix_out[..., :D]
    render_n = pix_out[..., D : D + 3]
    distort = pix_out[..., D + 3 : D + 4]
    median = pix_out[..., D + 4 : D + 5]
    t_img = t_final[..., None]
    alphas = 1.0 - t_img
    if backgrounds is not None:
        render = render + t_img * backgrounds[:, None, None, :]
    aux: Dict[str, Any] = {
        "n_isects": plan.n_isects,
        "isect_overflow": plan.overflow,
        "tiles_per_gauss": plan.cnt.reshape(I, N),
    }
    return render, alphas, render_n, distort, median, aux
