"""Public rasterization API, classic pinhole path.

Port of `gsplat_tpu/rendering.py` (render-mode predicates and
_campos_from_viewmats :46-80, render_projected :83-127, rasterization
:130-680 on the classic path): projection -> SH or broadcast features ->
tight plan, emission, sort and composite.  Shapes are static: the
intersection worklist has a fixed capacity (`isect_capacity`) with an
overflow flag in `meta`.  PyTorch runs eagerly, so nothing is jitted.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .ops.projection import fully_fused_projection
from .ops.rasterize import TILE, _round_up, rasterize_to_pixels
from .ops.sh import spherical_harmonics

_COLOR_MODES = {"RGB", "RGB-d", "RGB-Ed", "RGB+D", "RGB+ED"}
_DEPTH_MODES = {"D", "ED", "RGB+D", "RGB+ED"}
_HIT_DIST_MODES = {"d", "Ed", "RGB-d", "RGB-Ed"}
_EXPECTED_MODES = {"Ed", "ED", "RGB-Ed", "RGB+ED"}
DEFAULT_CHUNK = 128  # isect_capacity rounding, as the JAX package


def render_mode_has_color(mode: str) -> bool:
    return mode in _COLOR_MODES


def render_mode_has_depth_channel(mode: str) -> bool:
    return mode in _DEPTH_MODES or mode in _HIT_DIST_MODES


def render_mode_has_expected_depth(mode: str) -> bool:
    return mode in _EXPECTED_MODES


def _campos_from_viewmats(viewmats: torch.Tensor) -> torch.Tensor:
    """Camera centres [..., C, 3] from world-to-camera matrices: -R^T t,
    written elementwise (no TF32 product)."""
    R = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    return -(R * t[..., :, None]).sum(dim=-2)


def render_projected(
    means2d_f, conics_f, feats_f, op_f, radii_f, depths_f, width: int, height: int,
    tile_size: int, isect_capacity: int, backgrounds=None, masks=None,
    absgrad: bool = False, means2d_abs=None, row_capacity: Optional[int] = None,
    pack_payload: Optional[bool] = None, pack_grads: Optional[bool] = None,
):
    """Tile-intersect, sort and rasterize already-projected splats.

    Returns (render_colors [I, H, W, D], render_alphas [I, H, W, 1], aux).
    """
    return rasterize_to_pixels(
        means2d_f, conics_f, feats_f, op_f, width, height, radii_f, depths_f,
        isect_capacity, backgrounds=backgrounds, masks=masks, tile_size=tile_size,
        absgrad=absgrad, means2d_abs=means2d_abs, row_capacity=row_capacity,
        pack_payload=pack_payload, pack_grads=pack_grads,
    )


def _broadcast_feats(x, batch_dims, C, N, I):
    """[..., N, D] or [..., C, N, D] -> [I, N, D]."""
    if x.dim() == len(batch_dims) + 2:
        x = x[..., None, :, :]
    return x.expand(batch_dims + (C, N, x.shape[-1])).reshape(I, N, -1)


def rasterization(
    means: torch.Tensor,  # [..., N, 3]
    quats: Optional[torch.Tensor],  # [..., N, 4]
    scales: Optional[torch.Tensor],  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    colors: Optional[torch.Tensor],  # [..., (C,) N, D] or [N, K, D] SH
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    sh_degree: Optional[int] = None,
    tile_size: int = TILE,
    backgrounds: Optional[torch.Tensor] = None,  # [..., C, D]
    render_mode: str = "RGB",
    absgrad: bool = False,
    rasterize_mode: str = "classic",
    camera_model: str = "pinhole",
    covars: Optional[torch.Tensor] = None,  # [..., N, 3, 3] or [..., N, 6]
    masks: Optional[torch.Tensor] = None,  # [..., C, th, tw] bool tile masks
    isect_capacity: Optional[int] = None,
    row_capacity: Optional[int] = None,
    pack_payload: Optional[bool] = None,
    pack_grads: Optional[bool] = None,
    fast: bool = False,
    extra_signals: Optional[torch.Tensor] = None,  # [..., (C,) N, E] | [N, K, E]
    extra_signals_sh_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    with_ut: bool = False,
    with_eval3d: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Rasterize N 3D Gaussians to C image planes (optionally batched).

    Returns (render_colors [..., C, H, W, X], render_alphas
    [..., C, H, W, 1], meta).  X = D (+1 with a depth channel) for the
    render modes RGB, D, ED, RGB+D and RGB+ED.  `isect_capacity` defaults
    to 4 * total_cameras * N, rounded to 128; `meta["isect_overflow"]`
    reports truncation.
    """
    if with_ut or with_eval3d or camera_model == "lidar":
        raise NotImplementedError(
            "with_ut, with_eval3d and camera_model='lidar' belong to the "
            "cameras/UT/eval3d slice, ROADMAP Queue 1 item 9"
        )
    if fast:
        raise NotImplementedError(
            "fast=True (the bf16-pair packed inference path) is ROADMAP "
            "Queue 1 item 6; pass fast=False"
        )
    if absgrad or means2d_offset is not None:
        raise NotImplementedError(
            "absgrad and means2d_offset belong to the training slice, ROADMAP "
            "Queue 1 item 2"
        )
    if render_mode in _HIT_DIST_MODES:
        raise ValueError(
            f"hit-distance render mode {render_mode!r} requires with_eval3d=True"
        )
    if render_mode not in _COLOR_MODES | _DEPTH_MODES:
        raise ValueError(f"unknown render_mode: {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"unknown rasterize_mode: {rasterize_mode!r}")
    if tile_size not in (8, 16, 32):
        raise ValueError(f"tile_size must be 8, 16 or 32, got {tile_size}")

    has_color = render_mode_has_color(render_mode)
    has_depth = render_mode_has_depth_channel(render_mode)
    if has_color and colors is None:
        raise ValueError(f"colors are required for render_mode {render_mode!r}")

    batch_dims = tuple(viewmats.shape[:-3])
    B = math.prod(batch_dims) if batch_dims else 1
    C = viewmats.shape[-3]
    N = means.shape[-2]
    I = B * C

    # Degenerate-input sanitization: rows with non-finite inputs or a zero
    # quaternion become a safe zero-opacity gaussian before any math.
    ok_in = torch.isfinite(means).all(dim=-1)
    if quats is not None:
        ok_in &= torch.isfinite(quats).all(dim=-1)
        ok_in &= torch.sum(quats * quats, dim=-1) > 1e-24
    if scales is not None:
        ok_in &= torch.isfinite(scales).all(dim=-1)
    if covars is not None:
        ok_in &= torch.isfinite(covars.reshape(covars.shape[: means.dim() - 1] + (-1,))).all(dim=-1)
    ok_in &= torch.isfinite(opacities)
    okc = ok_in[..., None]
    means = torch.where(okc, means, 0.0)
    if quats is not None:
        unit_q = torch.zeros_like(quats)
        unit_q[..., 0] = 1.0
        quats = torch.where(okc, quats, unit_q)
    if scales is not None:
        scales = torch.where(okc, scales, 1.0)
    if covars is not None:
        if covars.shape[-2:] == (3, 3):
            eye = torch.eye(3, dtype=covars.dtype, device=covars.device).expand(covars.shape)
            covars = torch.where(okc[..., None], covars, eye)
        else:
            eye = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=covars.dtype,
                               device=covars.device)
            covars = torch.where(okc, covars, eye)
    opacities = torch.where(ok_in, opacities, 0.0)  # 0 < 1/255 -> culled

    calc_compensations = rasterize_mode == "antialiased"
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, covars, quats, scales, viewmats, Ks, width, height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        calc_compensations=calc_compensations, camera_model=camera_model,
        opacities=opacities,
    )

    radii_f = radii.reshape(I, N, 2)
    means2d_f = means2d.reshape(I, N, 2)
    depths_f = depths.reshape(I, N)
    conics_f = conics.reshape(I, N, 3)
    op = opacities[..., None, :].expand(batch_dims + (C, N)).reshape(I, N)
    if calc_compensations:
        op = op * compensations.reshape(I, N)

    def sh_feats(degree, coeffs):
        campos = _campos_from_viewmats(viewmats)  # [..., C, 3]
        dirs = means[..., None, :, :] - campos[..., None, :]  # [..., C, N, 3]
        return spherical_harmonics(degree, dirs, coeffs, masks=(radii > 0).all(dim=-1))

    n_extra = 0
    if has_color:
        if sh_degree is not None:
            feats = torch.clamp(sh_feats(sh_degree, colors) + 0.5, min=0.0)
            feats_f = feats.reshape(I, N, -1)
        else:
            feats_f = _broadcast_feats(colors, batch_dims, C, N, I)
        if extra_signals is not None:
            if extra_signals_sh_degree is not None:
                # signed channels: no clamp, unlike the colors
                ex_f = (sh_feats(extra_signals_sh_degree, extra_signals) + 0.5).reshape(I, N, -1)
            else:
                ex_f = _broadcast_feats(extra_signals, batch_dims, C, N, I)
            n_extra = ex_f.shape[-1]
            feats_f = torch.cat([feats_f, ex_f], dim=-1)
        if has_depth:
            feats_f = torch.cat([feats_f, depths_f[..., None]], dim=-1)
    else:
        if extra_signals is not None:
            raise ValueError("extra_signals require a color render mode")
        feats_f = depths_f[..., None]
    D_out = feats_f.shape[-1]

    bg_f = None
    if backgrounds is not None:
        bg_f = backgrounds.expand(batch_dims + (C, backgrounds.shape[-1])).reshape(I, -1)
        if bg_f.shape[-1] < D_out:  # zero background for the depth channel
            bg_f = torch.nn.functional.pad(bg_f, (0, D_out - bg_f.shape[-1]))

    th = -(-height // tile_size)
    tw = -(-width // tile_size)
    if isect_capacity is None:
        isect_capacity = _round_up(max(4 * I * N, DEFAULT_CHUNK), DEFAULT_CHUNK)
    else:
        isect_capacity = _round_up(isect_capacity, DEFAULT_CHUNK)
    masks_f = masks.reshape(I, th, tw) if masks is not None else None

    render_colors, render_alphas, aux = render_projected(
        means2d_f, conics_f, feats_f, op, radii_f, depths_f, width, height,
        tile_size, isect_capacity, backgrounds=bg_f, masks=masks_f,
        row_capacity=row_capacity, pack_payload=pack_payload, pack_grads=pack_grads,
    )

    if render_mode_has_expected_depth(render_mode):
        depth_ch = render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)
        render_colors = torch.cat([render_colors[..., :-1], depth_ch], dim=-1)

    out_shape = batch_dims + (C, height, width)
    render_colors = render_colors.reshape(out_shape + (D_out,))
    render_alphas = render_alphas.reshape(out_shape + (1,))

    render_extra = None
    if n_extra:
        # layout is [colors | extras | (depth)]
        d_col = D_out - n_extra - (1 if has_depth else 0)
        render_extra = render_colors[..., d_col : d_col + n_extra]
        render_colors = torch.cat(
            [render_colors[..., :d_col], render_colors[..., d_col + n_extra :]], dim=-1
        )

    meta = {
        "batch_ids": None,
        "camera_ids": None,
        "gaussian_ids": None,
        "radii": radii,
        "means2d": means2d,
        "depths": depths,
        "conics": conics,
        "opacities": op.reshape(batch_dims + (C, N)),
        "tile_width": tw,
        "tile_height": th,
        "tiles_per_gauss": aux["tiles_per_gauss"].reshape(batch_dims + (C, N)),
        "isect_ids": None,
        "flatten_ids": None,
        "isect_offsets": None,
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_batches": B,
        "n_cameras": C,
        "n_isects": aux["n_isects"],
        "isect_overflow": aux["isect_overflow"],
        "isect_capacity": isect_capacity,
    }
    if render_extra is not None:
        meta["render_extra_signals"] = render_extra
    return render_colors, render_alphas, meta
