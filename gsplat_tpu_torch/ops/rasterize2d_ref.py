"""The plain 2DGS rasterizer over the dense per-pixel worklist (oracle).

Port of `gsplat_tpu/ops/rasterize2d_ref.py:32-147`, walked by bands as the
3DGS oracle is (ops/rasterize_ref.py):

  h_u = px * w_M - u_M;  h_v = py * w_M - v_M          (M rows u, v, w)
  s   = cross(h_u, h_v);  skipped when s.z == 0
  sigma = 0.5 * min(s.x^2 + s.y^2, 2 * |pix - mean2d|^2) (in (s/s.z) space)
  alpha = min(MAX_ALPHA, op * exp(-sigma)); gated at ALPHA_THRESHOLD
  front-to-back blending with exclusive saturation (T <= 1e-4)

with the surfel outputs: normals composited as 3 more channels; the
distortion 2 * sum_i w_i (m_i A_i - B_i), m the last colour channel and
A_i, B_i the exclusive sums of w and w*m; the median, the last colour
channel of the last contributing splat whose entry transmittance exceeds
0.5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD
from .rasterize_ref import _colour_sum, _dense_bands, _put_pixels, _transmittance

FILTER_INV_SQUARE_2DGS = 2.0


def _surfel_alphas(m2, Mt, op, g, in_range, px, py) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated surfel alphas and the gate at each (pixel, slot); Mt holds
    each gaussian's ray transform as 9 row-major entries."""
    hu = [px * Mt[g, 6 + k] - Mt[g, 0 + k] for k in range(3)]
    hv = [py * Mt[g, 6 + k] - Mt[g, 3 + k] for k in range(3)]
    cx = hu[1] * hv[2] - hu[2] * hv[1]
    cy = hu[2] * hv[0] - hu[0] * hv[2]
    cz = hu[0] * hv[1] - hu[1] * hv[0]
    cz_safe = torch.where(cz == 0.0, 1.0, cz)
    su, sv = cx / cz_safe, cy / cz_safe
    sigma3 = su * su + sv * sv
    dx = m2[g, 0] - px
    dy = m2[g, 1] - py
    sigma2 = FILTER_INV_SQUARE_2DGS * (dx * dx + dy * dy)
    sigma = 0.5 * torch.minimum(sigma2, sigma3)
    alpha = torch.clamp(op[g] * torch.exp(-sigma), max=MAX_ALPHA)
    gate = (cz != 0.0) & (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_range
    return torch.where(gate, alpha, 0.0), gate


def rasterize_to_pixels_2dgs_ref(
    means2d: torch.Tensor,  # [I, N, 2]
    ray_transforms: torch.Tensor,  # [I, N, 3, 3]
    colors: torch.Tensor,  # [I, N, D] (depth in the last channel for distort)
    normals: torch.Tensor,  # [I, N, 3]
    opacities: torch.Tensor,  # [I, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [I, th, tw] int32
    flatten_ids: torch.Tensor,  # [P] int32
    n_isects: torch.Tensor,  # [] int32
    max_range: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(colors [I,H,W,D], alphas [I,H,W,1], normals [I,H,W,3], distort
    [I,H,W,1], median [I,H,W,1]), band by band."""
    I, N = means2d.shape[0], means2d.shape[1]
    D = colors.shape[-1]
    m2 = means2d.reshape(I * N, 2)
    Mt = ray_transforms.reshape(I * N, 9)
    cl = colors.reshape(I * N, D)
    nr = normals.reshape(I * N, 3)
    op = opacities.reshape(I * N)
    dev, dt = means2d.device, means2d.dtype
    shape = (I, image_height, image_width)
    render = torch.zeros(shape + (D,), dtype=colors.dtype, device=dev)
    render_n = torch.zeros(shape + (3,), dtype=normals.dtype, device=dev)
    t_img = torch.ones(shape, dtype=dt, device=dev)
    distort = torch.zeros(shape, dtype=dt, device=dev)
    median = torch.zeros(shape, dtype=dt, device=dev)
    for band in _dense_bands(isect_offsets, flatten_ids, n_isects, tile_size, image_width,
                             image_height, 0, max_range):
        g = band.g
        alpha, gate = _surfel_alphas(m2, Mt, op, g, band.in_range, band.px, band.py)
        cp_incl, t_entry = _transmittance(alpha)
        contribute = cp_incl > TRANSMITTANCE_THRESHOLD
        w = alpha * t_entry * contribute
        t_final = torch.amin(torch.where(contribute, cp_incl, 1.0), dim=-1)
        _put_pixels(render, band, _colour_sum(w, cl[g]))
        _put_pixels(render_n, band, _colour_sum(w, nr[g]))
        _put_pixels(t_img, band, t_final)
        m = cl[g, D - 1]
        A = torch.cumsum(w, dim=-1) - w  # exclusive
        B = torch.cumsum(w * m, dim=-1) - w * m
        _put_pixels(distort, band, torch.sum(2.0 * w * (m * A - B), dim=-1))
        med_mask = contribute & gate & (t_entry > 0.5)
        r = torch.arange(band.L, device=dev)
        idx = torch.where(med_mask, r, -1).amax(dim=-1)
        _put_pixels(median, band, torch.sum(torch.where(r == idx[..., None], m, 0.0), dim=-1))
    if backgrounds is not None:
        render = render + t_img[..., None] * backgrounds[:, None, None, :]
    return (render, (1.0 - t_img)[..., None], render_n, distort[..., None], median[..., None])
