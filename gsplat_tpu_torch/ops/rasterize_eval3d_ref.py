"""The plain eval3d rasterizer over the dense per-pixel worklist (oracle).

Port of `gsplat_tpu/ops/rasterize_eval3d_ref.py:40-135`, walked by bands
as the 3DGS oracle is (ops/rasterize_ref.py).  Each (gaussian, pixel)
response is taken in the gaussian's whitened local frame along the pixel's
world ray:

  u  = M r_d,  u_hat = u/||u||            (M = diag(1/s) R^T)
  g  = M (r_o - x)
  hit_t = -u_hat . g;  behind if hit_t < 0  (response forced to 0)
  grayDist = || u_hat x g ||^2
  alpha = min(opacity * exp(-0.5 grayDist), MAX_ALPHA)
  hitDist = || s * (u_hat * hit_t) ||       (optional last channel)
  normals: R[:, 2] flipped toward the ray   (optional)

The 3x3 products are written elementwise (no matrix product, no TF32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .math import quat_to_rotmat
from .projection import ALPHA_THRESHOLD, MAX_ALPHA
from .rasterize_eval3d import iscl_rot_from_quat_scale
from . import rasterize_ref as _ref
from .rasterize_ref import _colour_sum, _composite_weights, _dense_bands, _put_pixels

# an eval3d pair holds about four times the floats of a 3DGS pair
_PAIR_WEIGHT = 4


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def rasterize_to_pixels_eval3d_ref(
    means: torch.Tensor,  # [N, 3] world
    quats: torch.Tensor,  # [N, 4] wxyz
    scales: torch.Tensor,  # [N, 3]
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    rays: torch.Tensor,  # [I, H, W, 6] world (origin, direction)
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [I, th, tw] int32
    flatten_ids: torch.Tensor,  # [P] int32 into [I*N]
    n_isects: torch.Tensor,  # [] int32
    max_range: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    use_hit_distance: bool = False,
    return_normals: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """(render [I,H,W,D], alphas [I,H,W,1], normals [I,H,W,3] or None)."""
    I, N = colors.shape[0], colors.shape[1]
    D = colors.shape[-1]
    dev, dt = means.device, means.dtype
    M = iscl_rot_from_quat_scale(quats, scales)  # [N, 3, 3]
    cl = colors.reshape(I * N, D)
    op = opacities.reshape(I * N)
    R3 = quat_to_rotmat(quats)[..., :, 2] if return_normals else None
    shape = (I, image_height, image_width)
    render = torch.zeros(shape + (D,), dtype=colors.dtype, device=dev)
    t_img = torch.ones(shape, dtype=dt, device=dev)
    normals_img = torch.zeros(shape + (3,), dtype=dt, device=dev) if return_normals else None
    for band in _dense_bands(isect_offsets, flatten_ids, n_isects, tile_size, image_width,
                             image_height, 0, max_range, _ref._BAND_BUDGET // _PAIR_WEIGHT):
        gflat = band.g  # [nt, 1, L]
        g = gflat % N
        ray = rays[band.im, torch.clamp(band.y, max=image_height - 1),
                   torch.clamp(band.x, max=image_width - 1)][..., None, :]  # [nt, n_pix, 1, 6]
        ro = [ray[..., i] for i in range(3)]
        rd = [ray[..., 3 + i] for i in range(3)]
        x = [means[g, i] for i in range(3)]
        Mg = [[M[g, i, j] for j in range(3)] for i in range(3)]
        d = [ro[i] - x[i] for i in range(3)]
        u = [_dot3(Mg[i], rd) for i in range(3)]
        gv = [_dot3(Mg[i], d) for i in range(3)]
        un = torch.sqrt(_dot3(u, u))
        un = torch.where(un > 0.0, un, 1.0)
        uh = [ui / un for ui in u]
        hit_t = -_dot3(uh, gv)
        c = [uh[1] * gv[2] - uh[2] * gv[1], uh[2] * gv[0] - uh[0] * gv[2],
             uh[0] * gv[1] - uh[1] * gv[0]]
        gray = _dot3(c, c)
        alpha = torch.clamp(op[gflat] * torch.exp(-0.5 * gray), max=MAX_ALPHA)
        gate = (hit_t >= 0.0) & (alpha >= ALPHA_THRESHOLD) & band.in_range
        alpha = torch.where(gate, alpha, 0.0)
        weights, t_final = _composite_weights(alpha, axis=-1)
        vals = cl[gflat]  # [nt, 1, L, D]
        pix = _colour_sum(weights, vals)
        if use_hit_distance:
            s = [scales[g, i] * uh[i] for i in range(3)]
            hd = hit_t * torch.sqrt(_dot3(s, s))
            pix[..., D - 1] = (weights * hd).sum(-1)
        _put_pixels(render, band, pix)
        _put_pixels(t_img, band, t_final)
        if return_normals:
            n = [R3[g, i] for i in range(3)]
            sgn = torch.where(_dot3(n, rd) > 0.0, -1.0, 1.0)
            _put_pixels(normals_img, band,
                        torch.stack([(weights * (sgn * n[i])).sum(-1) for i in range(3)], -1))
    render_alpha = (1.0 - t_img)[..., None]
    if backgrounds is not None:
        render = render + t_img[..., None] * backgrounds[:, None, None, :]
    return render, render_alpha, normals_img
