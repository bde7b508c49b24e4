"""The plain rasterizer over the dense per-pixel worklist (the oracle).

Port of `gsplat_tpu/ops/rasterize_ref.py:32-134` (`_composite_weights`,
`rasterize_to_pixels_ref`, with backgrounds and masks): each pixel walks its
tile's depth-sorted span of the intersection list (isect_offsets +
flatten_ids) over `max_range` slots, with the kernels' semantics:

  sigma  = 0.5*(A*dx^2 + C*dy^2) + B*dx*dy      (conic = (A, B, C))
  alpha  = min(MAX_ALPHA, opacity * exp(-sigma)), gated where sigma < 0 or
           alpha < ALPHA_THRESHOLD
  stop   : the pixel saturates at the first gaussian with T*(1-alpha) <=
           TRANSMITTANCE_THRESHOLD; that gaussian is excluded
  out    = sum_i c_i * alpha_i * T_i;  render = out + T_final * background

The JAX function holds one [I, H, W, max_range] tensor per quantity, which
at 3840x2160 no card holds.  Here the image is walked by bands of
consecutive tiles (`_band_plan`): each band's slot axis is cut to its own
longest span (capped at `max_range`; the slots past a span are out of range
and add exactly nothing), and a band holds at most `_BAND_BUDGET` (pixel,
slot) pairs, so a tile row at 4k is one band unless its spans are long.
The per-pixel arithmetic is the JAX function's, except the transmittance:
a serial float32 product front to back, as the composite kernel K1 takes it
(`T *= 1 - alpha`), where XLA's CPU cumprod takes a blocked scan (16-wide
blocks, then their totals) and flushes denormals.  The colour sum is one
channel at a time (no matrix product, so no TF32 on the card).

The banding helpers here serve the other plain ops over the same worklist
(ops/contributing.py, ops/rasterize_sparse.py, ops/rasterize2d_ref.py,
ops/rasterize_eval3d_ref.py).
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD
from .rasterize_kernel import _serial_cumprod, _tile_batches

# (pixel, slot) pairs a band holds: 0.5 GB for each float32 quantity
_BAND_BUDGET = 1 << 27


def _transmittance(alpha: torch.Tensor, t0: Optional[torch.Tensor] = None):
    """(T after, T before) each slot along the last axis: the serial product
    of 1 - alpha, and that over 1 - alpha (alpha <= MAX_ALPHA < 1, so
    1 - alpha >= 0.01), both times an incoming transmittance t0 (one per
    row) when given."""
    one_m = 1.0 - alpha
    cp_incl = _serial_cumprod(one_m)
    cp_excl = cp_incl / one_m
    if t0 is not None:
        cp_incl = cp_incl * t0[..., None]
        cp_excl = cp_excl * t0[..., None]
    return cp_incl, cp_excl


def _weights_from_alphas(alpha: torch.Tensor, t0: Optional[torch.Tensor] = None):
    """(weights, contribute mask, t_final) along the last axis: a slot
    contributes while T after it stays above TRANSMITTANCE_THRESHOLD."""
    cp_incl, cp_excl = _transmittance(alpha, t0)
    contribute = cp_incl > TRANSMITTANCE_THRESHOLD
    weights = alpha * cp_excl * contribute
    t_final = torch.amin(
        torch.where(contribute, cp_incl, t0[..., None] if t0 is not None else 1.0), dim=-1
    )
    return weights, contribute, t_final


def _composite_weights(alphas: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back compositing weights along `axis` with saturation:
    (weights w_i = alpha_i * T_i * contribute_i, T_final)."""
    weights, _, t_final = _weights_from_alphas(alphas.movedim(axis, -1))
    return weights.movedim(-1, axis), t_final


def _span_bounds(isect_offsets: torch.Tensor, n_isects) -> torch.Tensor:
    """Each (image, tile)'s span [bounds[t], bounds[t+1]) of the sorted
    list: the offsets, then n_isects, int64 [I*th*tw + 1]."""
    n = torch.as_tensor(n_isects, device=isect_offsets.device).reshape(1).long()
    return torch.cat([isect_offsets.reshape(-1).long(), n])


def _span_counts(bounds: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Slots of [r0, r1) inside each span."""
    return torch.clamp(bounds[1:] - bounds[:-1] - r0, min=0, max=max(r1 - r0, 0))


def _band_plan(counts: torch.Tensor, n_pix: int, budget: Optional[int] = None
               ) -> List[Tuple[int, int, int]]:
    """(u0, u1, L) for consecutive units (tiles of n_pix pixels, or single
    pixels) whose padded work (units x n_pix x L) fits the budget, L the
    longest count among them (at least 1)."""
    return list(_tile_batches(counts, n_pix, _BAND_BUDGET if budget is None else budget))


def _slot_ids(bounds: torch.Tensor, flatten_ids: torch.Tensor, spans: torch.Tensor,
              r0: int, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat gaussian ids int64, in range) [n, L] of slots r0 .. r0+L-1 of
    the spans `spans` [n]; out-of-range slots read the list's last entry at
    most, as the JAX function's clamp."""
    start = bounds[spans]
    slot = start[:, None] + torch.arange(r0, r0 + L, device=bounds.device)
    in_range = slot < bounds[spans + 1][:, None]
    g = flatten_ids[torch.clamp(slot, max=max(flatten_ids.shape[0] - 1, 0))].long()
    return g, in_range


class _Band(NamedTuple):
    """Consecutive tiles of the dense worklist, pixels tile-major."""

    tiles: torch.Tensor  # [nt] flat (image, tile) ids
    L: int  # slots r0 .. r0+L-1
    g: torch.Tensor  # [nt, 1, L] flat gaussian ids (int64)
    in_range: torch.Tensor  # [nt, 1, L]
    im: torch.Tensor  # [nt, n_pix] image of each pixel
    x: torch.Tensor  # [nt, n_pix] pixel column
    y: torch.Tensor  # [nt, n_pix] pixel row
    inside: torch.Tensor  # [nt, n_pix] the pixel lies in the image
    px: torch.Tensor  # [nt, n_pix, 1] float32 pixel centre x
    py: torch.Tensor  # [nt, n_pix, 1]


def _dense_bands(isect_offsets, flatten_ids, n_isects, tile_size: int, image_width: int,
                 image_height: int, r0: int, r1: int, budget: Optional[int] = None
                 ) -> Iterator[_Band]:
    """The bands of the image over slots [r0, r1) of each tile's span."""
    th, tw = isect_offsets.shape[-2], isect_offsets.shape[-1]
    dev = isect_offsets.device
    bounds = _span_bounds(isect_offsets, n_isects)
    n_pix = tile_size * tile_size
    p = torch.arange(n_pix, device=dev)
    for t0, t1, L in _band_plan(_span_counts(bounds, r0, r1), n_pix, budget):
        tiles = torch.arange(t0, t1, device=dev)
        g, in_range = _slot_ids(bounds, flatten_ids, tiles, r0, L)
        tl = tiles % (tw * th)
        x = (tl % tw)[:, None] * tile_size + (p % tile_size)[None]
        y = (tl // tw)[:, None] * tile_size + (p // tile_size)[None]
        yield _Band(
            tiles=tiles, L=L, g=g[:, None, :], in_range=in_range[:, None, :],
            im=(tiles // (tw * th))[:, None].expand_as(x), x=x, y=y,
            inside=(x < image_width) & (y < image_height),
            px=x.to(torch.float32)[..., None] + 0.5, py=y.to(torch.float32)[..., None] + 0.5,
        )


def _put_pixels(out: torch.Tensor, band: _Band, values: torch.Tensor) -> None:
    """out[im, y, x] = values for the band's pixels inside the image."""
    m = band.inside
    out[band.im[m], band.y[m], band.x[m]] = values[m]


def _gated_alphas(m2, cn, op, g, in_range, px, py) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated alphas and the gate at each (pixel, slot) of flat gaussian ids g."""
    return _pair_alphas(m2[g, 0], m2[g, 1], cn[g, 0], cn[g, 1], cn[g, 2], op[g], in_range,
                        px, py)


def _pair_alphas(mx, my, a_, b_, c_, o, in_range, px, py) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated alphas and the gate from each slot's gaussian (mean, conic,
    opacity): the JAX function's arithmetic, operation by operation."""
    dx = mx - px
    dy = my - py
    sigma = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
    alpha = torch.clamp(o * torch.exp(-sigma), max=MAX_ALPHA)
    gate = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_range
    return torch.where(gate, alpha, 0.0), gate


def _colour_sum(weights: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """sum over slots of weights [..., L] * cols [..., L, D] -> [..., D],
    one channel at a time."""
    return torch.stack([(weights * cols[..., c]).sum(-1) for c in range(cols.shape[-1])], -1)


def rasterize_to_pixels_ref(
    means2d: torch.Tensor,  # [I, N, 2]
    conics: torch.Tensor,  # [I, N, 3]
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [I, tile_height, tile_width] int32
    flatten_ids: torch.Tensor,  # [P] int32 into [I*N]
    n_isects: torch.Tensor,  # [] int32
    max_range: int,  # upper bound on the per-tile worklist length
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    masks: Optional[torch.Tensor] = None,  # [I, tile_height, tile_width] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render [I, H, W, D] colors and [I, H, W, 1] alphas, band by band."""
    I, N = means2d.shape[0], means2d.shape[1]
    th, tw = isect_offsets.shape[-2], isect_offsets.shape[-1]
    D = colors.shape[-1]
    m2 = means2d.reshape(I * N, 2)
    cn = conics.reshape(I * N, 3)
    cl = colors.reshape(I * N, D)
    op = opacities.reshape(I * N)
    dev = means2d.device
    render = torch.zeros((I, image_height, image_width, D), dtype=colors.dtype, device=dev)
    t_img = torch.ones((I, image_height, image_width), dtype=means2d.dtype, device=dev)
    for band in _dense_bands(isect_offsets, flatten_ids, n_isects, tile_size, image_width,
                             image_height, 0, max_range):
        alpha, _ = _gated_alphas(m2, cn, op, band.g, band.in_range, band.px, band.py)
        weights, t_final = _composite_weights(alpha, axis=-1)
        _put_pixels(render, band, _colour_sum(weights, cl[band.g]))
        _put_pixels(t_img, band, t_final)
    render_alpha = (1.0 - t_img)[..., None]
    if backgrounds is not None:
        render = render + t_img[..., None] * backgrounds[:, None, None, :]
    if masks is not None:
        # masked-off tiles show the background with zero alpha
        ys = torch.arange(image_height, device=dev) // tile_size
        xs = torch.arange(image_width, device=dev) // tile_size
        mpix = masks[:, ys][:, :, xs][..., None]
        bg = (backgrounds[:, None, None, :] if backgrounds is not None
              else torch.zeros((I, 1, 1, D), dtype=render.dtype, device=dev))
        render = torch.where(mpix, render, bg)
        render_alpha = torch.where(mpix, render_alpha, 0.0)
    return render, render_alpha
