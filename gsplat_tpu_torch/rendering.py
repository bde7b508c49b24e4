"""Public rasterization API: the classic path, 3DGUT and eval3d (cameras
with distortion and rolling shutter, the spinning lidar), and 2DGS surfels.

Port of `gsplat_tpu/rendering.py` (render-mode predicates :46-80,
render_projected :83-127, rasterization
:130-680, rasterization_2dgs :683-813): projection (EWA, or the unscented
transform with `with_ut`) -> SH or broadcast features -> plan, emission,
sort and composite, either of the projected conics (classic) or along each
pixel's world-space ray (`with_eval3d`, ops/rasterize_eval3d.py).  Shapes
are static: the intersection worklist has a fixed capacity
(`isect_capacity`) with an overflow flag in `meta`.  PyTorch runs eagerly,
so nothing is jitted.

Screen-space gradients for densification: pass `means2d_offset` (zeros,
[..., C, N, 2], requires_grad) and read its `.grad` after `backward()`, as
the JAX package differentiates with respect to the same carrier.  With
`absgrad=True` that gradient is the tile-granular absolute gradient
(AbsGS).  Calling `meta["means2d"].retain_grad()` before `backward()` gives
the plain screen-space gradient without a carrier.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from .ops.projection import fully_fused_projection
from .ops.projection2d import fully_fused_projection_2dgs
from .ops.projection_kernel import campos_from_viewmats as _campos_from_viewmats  # noqa: F401
from .ops.projection_kernel import FIELD_DTYPES, project_shade, sanitize, sh_colors, widen
from .ops.projection_ut import fully_fused_projection_ut
from .ops.rasterize import TILE, _round_up, rasterize_to_pixels, rasterize_to_pixels_fast
from .ops.rasterize2d import rasterize_to_pixels_2dgs
from .ops.rasterize_eval3d import rasterize_to_pixels_eval3d
from .sensors.cameras import generate_rays, make_camera
from .sensors.lidars import angle_extent_to_element_grid, generate_lidar_rays
from .sensors.params import (
    FThetaCameraDistortionParameters,
    RollingShutterType,
    UnscentedTransformParameters,
)
from .utils.geometry import depth_to_normal
from .utils.trace import backward_phase, count, trace_range

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


def _warn_parity_arguments(sparse_grad: bool, segmented: bool, channel_chunk: int) -> None:
    """The JAX package's warnings for the parity arguments that change
    nothing (gsplat_tpu/rendering.py:215-246)."""
    if sparse_grad:
        warnings.warn(
            "sparse_grad=True has no effect on this path: gradients are dense tensors "
            "(visibility compaction already bounds the working set)",
            stacklevel=3,
        )
    if segmented:
        warnings.warn(
            "segmented=True has no effect on this path: the sort is a single sort over "
            "(tile, depth) keys",
            stacklevel=3,
        )
    if channel_chunk != 32:
        warnings.warn(
            "channel_chunk has no effect on this path: any channel count composites in "
            "groups of 32, the kernels' width",
            stacklevel=3,
        )


def _broadcast_feats(x, batch_dims, C, N, I):
    """[..., N, D] or [..., C, N, D] -> [I, N, D]."""
    if x.dim() == len(batch_dims) + 2:
        x = x[..., None, :, :]
    return x.expand(batch_dims + (C, N, x.shape[-1])).reshape(I, N, -1)


def _fused_route(means, quats, scales, opacities, colors, viewmats, Ks, sh_degree, covars,
                 camera_model, with_ut, with_eval3d, extra_signals, means2d_offset,
                 masks) -> bool:
    """Whether the projection and SH colours take the one-pass route
    (ops/projection_kernel.py:project_shade): nothing they feed needs a
    gradient, and the call is the case that pass implements, unbatched
    gaussians with quaternions and scales seen by pinhole cameras, float32
    or bfloat16 fields and SH colours of 3 channels shared by the cameras.
    Every other call takes the differentiable route."""
    inputs = (means, quats, scales, opacities, colors, viewmats, Ks)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return False
    if (covars is not None or quats is None or scales is None or camera_model != "pinhole"
            or with_ut or with_eval3d or extra_signals is not None
            or means2d_offset is not None or masks is not None):
        return False
    if means.dim() != 2 or opacities.dim() != 1 or viewmats.dim() != 3:
        return False
    fields = (means, quats, scales, opacities)
    if colors is not None and sh_degree is not None:
        if colors.dim() != 3 or colors.shape[-1] != 3:
            return False
        fields += (colors,)
    return (all(t.dtype in FIELD_DTYPES for t in fields)
            and viewmats.dtype == torch.float32 and Ks.dtype == torch.float32)


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
    packed: bool = True,  # parity argument: compaction is always on
    tile_size: int = TILE,
    backgrounds: Optional[torch.Tensor] = None,  # [..., C, D]
    render_mode: str = "RGB",
    sparse_grad: bool = False,  # parity argument: warns, gradients are dense
    absgrad: bool = False,
    rasterize_mode: str = "classic",
    channel_chunk: int = 32,  # parity argument: warns, channels go in groups of 32
    distributed: bool = False,  # parity argument: the single-process path
    camera_model: str = "pinhole",
    segmented: bool = False,  # parity argument: warns, one sort over (tile, depth)
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
    ut_params: Optional[UnscentedTransformParameters] = None,
    radial_coeffs: Optional[torch.Tensor] = None,  # [..., C, <=6]
    tangential_coeffs: Optional[torch.Tensor] = None,  # [..., C, 2]
    thin_prism_coeffs: Optional[torch.Tensor] = None,  # [..., C, 4]
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[torch.Tensor] = None,  # [..., C, 4, 4]
    rays: Optional[torch.Tensor] = None,  # [C, H, W, 6] (eval3d only)
    return_normals: bool = False,  # eval3d only
    lidar_coeffs=None,  # sensors.lidars.LidarModel (camera_model="lidar")
    global_z_order: bool = True,
    external_distortion=None,  # sensors.external windshield parameters (UT only)
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Rasterize N 3D Gaussians to C image planes (optionally batched).

    Returns (render_colors [..., C, H, W, X], render_alphas
    [..., C, H, W, 1], meta).  X = D (+1 with a depth channel) for the
    render modes RGB, D, ED, RGB+D and RGB+ED, and with `with_eval3d` the
    hit-distance modes d, Ed, RGB-d and RGB-Ed, whose last channel is the
    distance along the ray.  `isect_capacity` defaults to
    4 * total_cameras * N, rounded to 128; `meta["isect_overflow"]` reports
    truncation.

    `fast=True` is the inference path (rasterize_to_pixels_fast): the
    bf16-pair packed payload, no autograd, about 2^-9 per field; it takes
    the color render modes only and neither `absgrad` nor `masks`, and
    reports `tiles_per_gauss` as zeros.  `pack_payload` and `pack_grads`
    choose the packed payload and the packed per-slot gradients of the
    differentiable op (rasterize_to_pixels); both default to off.  The
    eval3d composite has no packed mode, and with `with_eval3d` `fast` has
    no effect, as in the JAX package.

    `with_ut` projects through the unscented transform, which takes the
    camera models' distortion (`radial_coeffs`, ...), `ftheta_coeffs`,
    `rolling_shutter` with `viewmats_rs`, and `external_distortion`;
    `with_eval3d` evaluates each gaussian along each pixel's ray (from the
    camera model, or `rays`), with `return_normals` in
    meta["render_normals"].  camera_model="lidar" renders the element grid
    of `lidar_coeffs` (with_ut and with_eval3d both required).

    A call whose projection needs no gradient (grad mode off, or no input
    requiring it) and that is the plain pinhole case takes the one-pass
    projection and SH colours (ops/projection_kernel.py, `_fused_route`):
    the same radii, means2d, depths, conics and opacities, bit for bit.
    Every other call runs the differentiable PyTorch route, which widens
    bfloat16 fields to float32 first.

    `packed`, `sparse_grad`, `channel_chunk`, `distributed` and `segmented`
    sit where the JAX package's `rasterization` has them and behave as
    there: every call compacts by visibility (`packed`), one process renders
    (`distributed`), and `sparse_grad=True`, `segmented=True` and a
    `channel_chunk` other than 32 warn that they change nothing.  Any
    channel count D renders: the composites take D > 32 in groups of 32
    channels (upstream's `channel_chunk` at its default), each with the
    geometry, forward and backward; `channel_chunk` does not set that size.
    """
    _warn_parity_arguments(sparse_grad, segmented, channel_chunk)
    if camera_model == "lidar":
        if lidar_coeffs is None:
            raise ValueError("camera_model='lidar' requires lidar_coeffs")
        if not (with_ut and with_eval3d):
            raise ValueError("lidar rendering requires with_ut=True and with_eval3d=True")
        width, height = lidar_coeffs.n_columns, lidar_coeffs.n_rows  # the element grid
    if absgrad and means2d_offset is None:
        raise ValueError("absgrad=True needs means2d_offset, the carrier of the gradient")
    if render_mode in _HIT_DIST_MODES and not with_eval3d:
        raise ValueError(
            f"hit-distance render mode {render_mode!r} requires with_eval3d=True"
        )
    if render_mode not in _COLOR_MODES | _DEPTH_MODES | _HIT_DIST_MODES:
        raise ValueError(f"unknown render_mode: {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"unknown rasterize_mode: {rasterize_mode!r}")
    if tile_size not in (8, 16, 32):
        raise ValueError(f"tile_size must be 8, 16 or 32, got {tile_size}")
    if with_eval3d:
        if rasterize_mode != "classic":
            raise ValueError("rasterize_mode='antialiased' is not supported with with_eval3d")
        if viewmats.dim() != 3:
            raise ValueError("eval3d takes unbatched inputs ([N, 3] means, [C, 4, 4] viewmats)")
        if means2d_offset is not None:
            # the ray composite carries no screen-space gradient
            raise ValueError("absgrad and means2d_offset have no carrier with with_eval3d")
        if pack_payload or pack_grads or masks is not None:
            raise ValueError("pack_payload, pack_grads and masks apply to the classic "
                             "composite, not to with_eval3d")
    if rays is not None and not with_eval3d:
        raise ValueError("rays input is only supported with with_eval3d=True")
    has_distortion = (
        radial_coeffs is not None or tangential_coeffs is not None
        or thin_prism_coeffs is not None or ftheta_coeffs is not None
        or rolling_shutter != RollingShutterType.GLOBAL
    )
    if has_distortion and not with_ut:
        raise ValueError("distortion coefficients / rolling shutter require with_ut=True")
    if with_ut and rasterize_mode != "classic":
        raise ValueError("rasterize_mode='antialiased' is not supported with with_ut")

    has_color = render_mode_has_color(render_mode)
    has_depth = render_mode_has_depth_channel(render_mode)
    if has_color and colors is None:
        raise ValueError(f"colors are required for render_mode {render_mode!r}")

    batch_dims = tuple(viewmats.shape[:-3])
    B = math.prod(batch_dims) if batch_dims else 1
    C = viewmats.shape[-3]
    N = means.shape[-2]
    I = B * C

    with trace_range("project"):
        calc_compensations = rasterize_mode == "antialiased"
        fused = _fused_route(
            means, quats, scales, opacities, colors if has_color else None, viewmats, Ks,
            sh_degree, covars, camera_model, with_ut, with_eval3d, extra_signals,
            means2d_offset, masks,
        )
        sh_done = None
        if fused:
            # one pass, no autograd: ops/projection_kernel.py
            radii, means2d, depths, conics, op, sh_done = project_shade(
                means, quats, scales, opacities,
                colors if has_color and sh_degree is not None else None, viewmats, Ks, width,
                height, sh_degree=sh_degree, eps2d=eps2d, near_plane=near_plane,
                far_plane=far_plane, radius_clip=radius_clip, antialiased=calc_compensations,
            )
            count("project.fused", I * N)
            if sh_degree is None:
                colors = widen(colors)  # colours without SH are broadcast as float32
        else:
            means, quats, scales, opacities, colors = map(
                widen, (means, quats, scales, opacities, colors))
            means, quats, scales, opacities, covars = sanitize(
                means, quats, scales, opacities, covars)
            if with_ut:
                # sigma points through the nonlinear camera model
                with trace_range("project.ut"):
                    radii, means2d, depths, conics, compensations = fully_fused_projection_ut(
                        means, quats, scales, opacities, viewmats, Ks, width, height,
                        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
                        radius_clip=radius_clip, calc_compensations=calc_compensations,
                        camera_model=camera_model, ut_params=ut_params,
                        radial_coeffs=radial_coeffs, tangential_coeffs=tangential_coeffs,
                        thin_prism_coeffs=thin_prism_coeffs, ftheta_coeffs=ftheta_coeffs,
                        rolling_shutter=rolling_shutter, viewmats_rs=viewmats_rs,
                        lidar_coeffs=lidar_coeffs, global_z_order=global_z_order,
                        external_distortion=external_distortion,
                    )
                count("project.ut", I * N)
            else:
                radii, means2d, depths, conics, compensations = fully_fused_projection(
                    means, covars, quats, scales, viewmats, Ks, width, height, eps2d=eps2d,
                    near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
                    calc_compensations=calc_compensations, camera_model=camera_model,
                    opacities=opacities,
                )
            op = opacities[..., None, :].expand(batch_dims + (C, N)).reshape(I, N)
            if calc_compensations:
                op = op * compensations.reshape(I, N)

        radii_f = radii.reshape(I, N, 2)
        means2d_f = means2d.reshape(I, N, 2)
        depths_f = depths.reshape(I, N)
        conics_f = conics.reshape(I, N, 3)

        def sh_feats(degree, coeffs):
            with trace_range("project.sh"):
                return sh_colors(degree, coeffs, means, viewmats, radii)

        n_extra = 0
        if has_color:
            if sh_done is not None:
                feats_f = sh_done
            elif sh_degree is not None:
                feats = torch.clamp(sh_feats(sh_degree, colors) + 0.5, min=0.0)
                feats_f = feats.reshape(I, N, -1)
            else:
                feats_f = _broadcast_feats(colors, batch_dims, C, N, I)
            if extra_signals is not None:
                if extra_signals_sh_degree is not None:
                    # signed channels: no clamp, unlike the colors
                    ex_f = (sh_feats(extra_signals_sh_degree, extra_signals) + 0.5).reshape(
                        I, N, -1)
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
        m2_render, m2_abs = means2d_f, None
        if means2d_offset is not None:
            off = means2d_offset.reshape(I, N, 2)
            if absgrad:
                m2_abs = off  # its gradient becomes the AbsGS gradient
            else:
                m2_render = means2d_f + off  # its gradient is the screen-space gradient

        if with_eval3d:
            # the rays of the camera model or the lidar; the projection's radii
            # tile (for a lidar, converted to its element grid)
            with trace_range("project.rays"):
                if camera_model == "lidar":
                    if rays is None:
                        rays = generate_lidar_rays(lidar_coeffs, viewmats, viewmats_rs)
                    m2g, rdg = angle_extent_to_element_grid(lidar_coeffs, means2d, radii)
                    means2d_f, radii_f = m2g.reshape(I, N, 2), rdg.reshape(I, N, 2)
                elif rays is None:
                    camera = make_camera(
                        camera_model, width, height,
                        focal_lengths=(None if camera_model == "ftheta"
                                       else torch.stack([Ks[..., 0, 0], Ks[..., 1, 1]], dim=-1)),
                        principal_points=Ks[..., :2, 2], radial_coeffs=radial_coeffs,
                        tangential_coeffs=tangential_coeffs,
                        thin_prism_coeffs=thin_prism_coeffs, ftheta_coeffs=ftheta_coeffs,
                        shutter_type=rolling_shutter, external_distortion=external_distortion,
                    )
                    rays = generate_rays(camera, width, height, viewmats, viewmats_rs)

    th = -(-height // tile_size)
    tw = -(-width // tile_size)
    if isect_capacity is None:
        isect_capacity = _round_up(max(4 * I * N, DEFAULT_CHUNK), DEFAULT_CHUNK)
    else:
        isect_capacity = _round_up(isect_capacity, DEFAULT_CHUNK)
    masks_f = masks.reshape(I, th, tw) if masks is not None else None

    if with_eval3d:
        backward_phase("project.bwd", means, quats, scales, feats_f, op)
        render_colors, render_alphas, render_normals, aux = rasterize_to_pixels_eval3d(
            means, quats, scales, feats_f, op, rays, width, height, radii_f, depths_f, means2d_f,
            isect_capacity, backgrounds=bg_f, tile_size=tile_size,
            use_hit_distance=render_mode in _HIT_DIST_MODES, return_normals=return_normals,
        )
        with trace_range("composite"):
            if render_mode_has_expected_depth(render_mode):
                depth_ch = render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)
                render_colors = torch.cat([render_colors[..., :-1], depth_ch], dim=-1)
            render_colors, render_extra = _split_extra(render_colors, n_extra, has_depth)
        backward_phase("composite.bwd", render_colors, render_alphas, render_normals,
                       render_extra)
        meta = {
            "radii": radii,
            "means2d": means2d,
            "depths": depths,
            "conics": conics,
            "opacities": op.reshape(C, N),
            "rays": rays,
            "render_normals": render_normals,
            "width": width,
            "height": height,
            "tile_size": tile_size,
            "n_batches": B,
            "n_cameras": C,
            "n_isects": aux["n_isects"],
            "isect_overflow": aux["isect_overflow"],
            "isect_capacity": isect_capacity,
            "tiles_per_gauss": aux["tiles_per_gauss"],
        }
        if render_extra is not None:
            meta["render_extra_signals"] = render_extra
        return render_colors, render_alphas, meta

    backward_phase("project.bwd", m2_render, conics_f, feats_f, op)
    if fast:
        if absgrad or masks_f is not None:
            raise ValueError("fast=True is inference-only: absgrad/masks unsupported")
        if has_depth:
            # the packed payload would quantize a depth channel to bf16
            raise ValueError(
                "fast=True supports color render modes only (depth channels would be "
                "quantized to bf16 by the packed payload); use fast=False for "
                "D/ED/RGB+D/RGB+ED"
            )
        render_colors, render_alphas, aux = rasterize_to_pixels_fast(
            m2_render, conics_f, feats_f, op, width, height, radii_f, depths_f,
            isect_capacity, backgrounds=bg_f, tile_size=tile_size, row_capacity=row_capacity,
        )
        aux["tiles_per_gauss"] = torch.zeros((I, N), dtype=torch.int32, device=radii_f.device)
    else:
        render_colors, render_alphas, aux = render_projected(
            m2_render, conics_f, feats_f, op, radii_f, depths_f, width, height,
            tile_size, isect_capacity, backgrounds=bg_f, masks=masks_f,
            absgrad=absgrad, means2d_abs=m2_abs, row_capacity=row_capacity,
            pack_payload=pack_payload, pack_grads=pack_grads,
        )

    with trace_range("composite"):
        if render_mode_has_expected_depth(render_mode):
            depth_ch = render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)
            render_colors = torch.cat([render_colors[..., :-1], depth_ch], dim=-1)

        out_shape = batch_dims + (C, height, width)
        render_colors = render_colors.reshape(out_shape + (D_out,))
        render_alphas = render_alphas.reshape(out_shape + (1,))

        render_colors, render_extra = _split_extra(render_colors, n_extra, has_depth)
    backward_phase("composite.bwd", render_colors, render_alphas, render_extra)

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


def _split_extra(render_colors, n_extra: int, has_depth: bool):
    """[colors | extras | (depth)] -> (colors with depth, extras or None)."""
    if not n_extra:
        return render_colors, None
    d_col = render_colors.shape[-1] - n_extra - (1 if has_depth else 0)
    extra = render_colors[..., d_col : d_col + n_extra]
    return torch.cat([render_colors[..., :d_col], render_colors[..., d_col + n_extra :]],
                     dim=-1), extra


_MODES_2DGS = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


def rasterization_2dgs(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    colors: torch.Tensor,  # [(C,) N, D] or [N, K, D] SH
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    sh_degree: Optional[int] = None,
    tile_size: int = TILE,
    backgrounds: Optional[torch.Tensor] = None,  # [C, D]
    render_mode: str = "RGB",
    distloss: bool = False,  # parity argument: the distortion is always rendered
    depth_mode: str = "expected",  # "expected" | "median"
    isect_capacity: Optional[int] = None,
    densify: Optional[torch.Tensor] = None,  # [C, N, 2] screen-gradient carrier
) -> Tuple[torch.Tensor, ...]:
    """Rasterize 2D surfel gaussians (2DGS).

    Returns (render_colors [C, H, W, X], render_alphas [C, H, W, 1],
    render_normals [C, H, W, 3] in the world frame, normals_from_depth
    [C, H, W, 3] or None, render_distort [C, H, W, 1], render_median
    [C, H, W, 1], meta).  The depth channel is always rendered last (it drives
    the distortion and the median); X drops it for RGB.  `densify` (zeros,
    requires_grad) receives the screen gradient that the default strategy
    reads, as meta["gradient_2dgs"].  `distloss` sits where the JAX
    package's `rasterization_2dgs` has it and, as there, changes nothing.
    """
    if render_mode not in _MODES_2DGS:
        raise ValueError(f"unsupported 2DGS render_mode: {render_mode!r}")
    if depth_mode not in ("expected", "median"):
        raise ValueError(f"depth_mode must be 'expected' or 'median', got {depth_mode!r}")
    has_color = render_mode_has_color(render_mode)
    has_depth = render_mode_has_depth_channel(render_mode)
    C = viewmats.shape[-3]
    N = means.shape[-2]

    with trace_range("project"):
        radii, means2d, depths, ray_transforms, normals = fully_fused_projection_2dgs(
            means, quats, scales, viewmats, Ks, width, height, near_plane=near_plane,
            far_plane=far_plane,
        )
        op = opacities[None].expand(C, N)
        if has_color:
            if sh_degree is not None:
                with trace_range("project.sh"):
                    feats = torch.clamp(sh_colors(sh_degree, colors, means, viewmats, radii) + 0.5,
                                        min=0.0)
            else:
                feats = (colors[None] if colors.dim() == 2 else colors).expand(
                    C, N, colors.shape[-1])
            feats = torch.cat([feats, depths[..., None]], dim=-1)
        else:
            feats = depths[..., None]
        D_out = feats.shape[-1]

        if isect_capacity is None:
            isect_capacity = _round_up(max(4 * C * N, DEFAULT_CHUNK), DEFAULT_CHUNK)
        bg = backgrounds
        if bg is not None and bg.shape[-1] < D_out:
            bg = torch.nn.functional.pad(bg, (0, D_out - bg.shape[-1]))
        rt = ray_transforms.reshape(C, N, 9)

    backward_phase("project.bwd", means2d, rt, feats, normals, op)
    render, alphas, render_n, distort, median, aux = rasterize_to_pixels_2dgs(
        means2d, rt, feats, normals, op, width, height, radii,
        depths, isect_capacity, backgrounds=bg, tile_size=tile_size, densify=densify,
    )
    with trace_range("composite"):
        if render_mode_has_expected_depth(render_mode):
            depth_ch = render[..., -1:] / torch.clamp(alphas, min=1e-10)
            render = torch.cat([render[..., :-1], depth_ch], dim=-1)
        render_full = render
        if has_color and not has_depth:
            render = render[..., :-1]

        # the rendered normals are in the camera frame: R_cw^T n, elementwise
        R_cw = viewmats[..., :3, :3]  # [C, 3, 3]
        render_normals = (R_cw[:, None, None, :, :] * render_n[..., :, None]).sum(dim=-2)

        normals_from_depth = None
        if has_color and has_depth:
            depth_for_normal = median if depth_mode == "median" else render_full[..., -1:]
            normals_from_depth = depth_to_normal(depth_for_normal, torch.linalg.inv(viewmats),
                                                 Ks)
    backward_phase("composite.bwd", render, alphas, render_normals, normals_from_depth,
                   distort, median)

    meta = {
        "radii": radii,
        "means2d": means2d,
        "depths": depths,
        "ray_transforms": ray_transforms,
        "opacities": op,
        "normals": normals,
        "tiles_per_gauss": aux["tiles_per_gauss"],
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_cameras": C,
        "n_isects": aux["n_isects"],
        "isect_overflow": aux["isect_overflow"],
        "render_distort": distort,
        "gradient_2dgs": densify,
    }
    return render, alphas, render_normals, normals_from_depth, distort, median, meta
