"""Sparse rasterization: render only the requested pixels.

Port of `gsplat_tpu/ops/rasterize_sparse.py:32-228`:
rasterize_to_pixels_sparse and the three `_sparse` contributing variants.
Each requested pixel walks its tile's depth-sorted span (isect_offsets +
flatten_ids, the dense path's structures) over `max_range` slots, in
batches of pixels as the dense oracle walks bands (ops/rasterize_ref.py):
each batch's slot axis is cut to its own longest span.  The result at a
pixel is the dense oracle's there.

The backward is a `torch.autograd.Function` with no atomics: it replays
each batch and writes out the chain rule per (pixel, slot) (`_pair_grads`),
so the per-pair gradient terms come without a scatter; only the
contributing pairs carry any (a gated slot's alpha is a select of 0, and a
slot past the stop has weight 0 and no say in T_final).  Those pairs are
sorted stably by flat gaussian id and each gaussian's run is summed by K5
(`segsum_kernel.segment_rowsum`) in that order, on the card as on the CPU,
so the gradients are equal from run to run, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import rasterize_ref as _ref
from .contributing import _count_rows, _id_rows, _top_rows
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD
from .rasterize_ref import (
    _band_plan,
    _colour_sum,
    _gated_alphas,
    _slot_ids,
    _span_bounds,
    _span_counts,
    _transmittance,
    _weights_from_alphas,
)
from .segsum_kernel import segment_rowsum

# the backward holds about twice the forward's per-pair tensors
_BWD_SHARE = 2


def _pixel_batches(isect_offsets, flatten_ids, n_isects, pixels, image_ids, tile_size: int,
                   max_range: int, budget: int):
    """(p0, p1, flat ids [n, L], in range [n, L], px [n, 1], py [n, 1]) for
    consecutive requested pixels whose padded work fits the budget."""
    th, tw = isect_offsets.shape[-2], isect_offsets.shape[-1]
    bounds = _span_bounds(isect_offsets, n_isects)
    py_i = pixels[:, 0].long()
    px_i = pixels[:, 1].long()
    spans = (image_ids.long() * (th * tw) + torch.div(py_i, tile_size, rounding_mode="floor") * tw
             + torch.div(px_i, tile_size, rounding_mode="floor"))
    px = px_i.to(torch.float32)[:, None] + 0.5
    py = py_i.to(torch.float32)[:, None] + 0.5
    counts = _span_counts(bounds, 0, max_range)[spans]
    for p0, p1, L in _band_plan(counts, 1, budget):
        g, in_range = _slot_ids(bounds, flatten_ids, spans[p0:p1], 0, L)
        yield p0, p1, g, in_range, px[p0:p1], py[p0:p1]


def _composite(alpha, colors_g, bg):
    """(render [n, D], alpha [n, 1], contributing mask [n, L]) of a batch."""
    weights, contribute, t_final = _weights_from_alphas(alpha)
    render = _colour_sum(weights, colors_g)
    if bg is not None:
        render = render + t_final[:, None] * bg
    return render, (1.0 - t_final)[:, None], contribute


class _SparseComposite(torch.autograd.Function):
    """The sparse composite with a deterministic backward (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, backgrounds, pixels, image_ids,
                isect_offsets, flatten_ids, n_isects, tile_size, max_range):
        I, N = means2d.shape[0], means2d.shape[1]
        D = colors.shape[-1]
        m2, cn = means2d.reshape(I * N, 2), conics.reshape(I * N, 3)
        cl, op = colors.reshape(I * N, D), opacities.reshape(I * N)
        P = pixels.shape[0]
        render = torch.zeros((P, D), dtype=colors.dtype, device=means2d.device)
        alphas = torch.zeros((P, 1), dtype=means2d.dtype, device=means2d.device)
        for p0, p1, g, rng, px, py in _pixel_batches(isect_offsets, flatten_ids, n_isects,
                                                     pixels, image_ids, tile_size, max_range,
                                                     _ref._BAND_BUDGET):
            alpha, _ = _gated_alphas(m2, cn, op, g, rng, px, py)
            bg = None if backgrounds is None else backgrounds[image_ids[p0:p1].long()]
            render[p0:p1], alphas[p0:p1], _ = _composite(alpha, cl[g], bg)
        ctx.save_for_backward(means2d, conics, colors, opacities, backgrounds, pixels, image_ids,
                              isect_offsets, flatten_ids, n_isects)
        ctx.tile_size, ctx.max_range = tile_size, max_range
        return render, alphas

    @staticmethod
    def backward(ctx, v_render, v_alpha):
        (means2d, conics, colors, opacities, backgrounds, pixels, image_ids, isect_offsets,
         flatten_ids, n_isects) = ctx.saved_tensors
        I, N = means2d.shape[0], means2d.shape[1]
        D = colors.shape[-1]
        m2, cn = means2d.reshape(I * N, 2), conics.reshape(I * N, 3)
        cl, op = colors.reshape(I * N, D), opacities.reshape(I * N)
        dev = means2d.device
        keys, terms, v_bg_pix = [], [], []
        for p0, p1, g, rng, px, py in _pixel_batches(
                isect_offsets, flatten_ids, n_isects, pixels, image_ids, ctx.tile_size,
                ctx.max_range, _ref._BAND_BUDGET // _BWD_SHARE):
            bg = None if backgrounds is None else backgrounds[image_ids[p0:p1].long()]
            live, pair, v_bg_b = _pair_grads(m2, cn, cl, op, g, rng, px, py, bg,
                                             v_render[p0:p1], v_alpha[p0:p1])
            keys.append(g[live])
            terms.append(pair[live])
            v_bg_pix.append(v_bg_b)
        # per-gaussian sums: a stable sort of the pairs by gaussian, then K5
        F = 6 + D
        v_flat = torch.zeros((I * N, F), dtype=torch.float32, device=dev)
        keys = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.long, device=dev)
        if keys.numel():
            terms = torch.cat(terms)
            keys_s, order = torch.sort(keys, stable=True)
            first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               keys_s[1:] != keys_s[:-1]])
            starts = torch.nonzero(first)[:, 0]
            bounds = torch.cat([starts, starts.new_full((1,), keys_s.shape[0])]).to(torch.int32)
            sums = segment_rowsum(terms[order].t().contiguous(), bounds)
            v_flat[keys_s[starts]] = sums.t()
        v_bg = None
        if backgrounds is not None:
            v_pix = torch.cat(v_bg_pix) if v_bg_pix else torch.zeros((0, D), device=dev)
            im = image_ids.long()
            v_bg = torch.stack([v_pix[im == i].sum(0) for i in range(I)])
        return (v_flat[:, 0:2].reshape(I, N, 2), v_flat[:, 2:5].reshape(I, N, 3),
                v_flat[:, 5:5 + D].reshape(I, N, D), v_flat[:, 5 + D].reshape(I, N),
                v_bg, None, None, None, None, None, None, None)


def _pair_grads(m2, cn, cl, op, g, in_range, px, py, bg, v_c, v_a):
    """The gradient terms of each (pixel, slot) of a batch, by the chain
    rule written out: (contributing mask [n, L], terms [n, L, 6 + D]: the
    mean's 2, the conic's 3, the colour's D and the opacity's 1, and the
    background's [n, D] or None).

    render = sum_i w_i c_i + T bg and alpha = 1 - T, where w_i = alpha_i T_i
    over the contributing slots C (a prefix) and T = prod_{i in C}(1 -
    alpha_i); for i in C, dL/dalpha_i = T_i (v_c . c_i) - (sum_{k in C, k > i}
    w_k (v_c . c_k) + T v_T) / (1 - alpha_i), with v_T = v_c . bg - v_a.  A
    slot outside C has none: its alpha is a select of 0, or its weight is 0
    and it has no say in T."""
    mx, my = m2[g, 0], m2[g, 1]
    a_, b_, c_ = cn[g, 0], cn[g, 1], cn[g, 2]
    o = op[g]
    cols = cl[g]  # [n, L, D]
    dx = mx - px
    dy = my - py
    sigma = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
    vis = torch.exp(-sigma)
    raw = o * vis
    alpha = torch.clamp(raw, max=MAX_ALPHA)
    gate = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & in_range
    alpha = torch.where(gate, alpha, 0.0)
    cp_incl, t_before = _transmittance(alpha)
    contribute = cp_incl > TRANSMITTANCE_THRESHOLD
    live = gate & contribute
    w = alpha * t_before * contribute
    t_final = torch.amin(torch.where(contribute, cp_incl, 1.0), dim=-1, keepdim=True)
    gc = (cols * v_c[:, None, :]).sum(-1)  # v_c . c_i
    v_T = -v_a
    if bg is not None:
        v_T = v_T + (v_c * bg).sum(-1, keepdim=True)
    gw = gc * w
    after = gw.sum(-1, keepdim=True) - torch.cumsum(gw, dim=-1)  # sum over k > i
    v_alpha = torch.where(live, t_before * gc - (after + t_final * v_T) / (1.0 - alpha), 0.0)
    v_raw = torch.where(raw < MAX_ALPHA, v_alpha, 0.0)
    v_sigma = -v_raw * raw
    parts = [v_sigma * (a_ * dx + b_ * dy), v_sigma * (c_ * dy + b_ * dx),
             v_sigma * 0.5 * dx * dx, v_sigma * dx * dy, v_sigma * 0.5 * dy * dy]
    v_col = w[..., None] * v_c[:, None, :]
    terms = torch.cat([torch.stack(parts, -1), v_col, (v_raw * vis)[..., None]], -1)
    return live, terms, None if bg is None else t_final * v_c


def rasterize_to_pixels_sparse(
    means2d: torch.Tensor,  # [I, N, 2]
    conics: torch.Tensor,  # [I, N, 3]
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    pixels: torch.Tensor,  # [P, 2] (row, col) int32
    image_ids: torch.Tensor,  # [P] int32
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [I, th, tw] int32
    flatten_ids: torch.Tensor,  # [n_isects_cap] int32 into [I*N]
    n_isects: torch.Tensor,  # [] int32
    max_range: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the requested pixels: (colors [P, D], alphas [P, 1]), the
    dense rasterizer's values there (gates, clamp, stop, background)."""
    del image_width, image_height  # the pixels are given
    return _SparseComposite.apply(means2d, conics, colors, opacities, backgrounds, pixels,
                                  image_ids, isect_offsets, flatten_ids,
                                  torch.as_tensor(n_isects, device=means2d.device),
                                  tile_size, max_range)


def _sparse_map(row_fn, means2d, conics, opacities, pixels, image_ids, tile_size, isect_offsets,
                flatten_ids, n_isects, max_range, outs):
    """row_fn(alpha, gate, g) on every batch of requested pixels, written to
    `outs` ([P, ...] each)."""
    I, N = means2d.shape[0], means2d.shape[1]
    m2, cn, op = means2d.reshape(I * N, 2), conics.reshape(I * N, 3), opacities.reshape(I * N)
    for p0, p1, g, rng, px, py in _pixel_batches(isect_offsets, flatten_ids, n_isects, pixels,
                                                 image_ids, tile_size, max_range,
                                                 _ref._BAND_BUDGET):
        alpha, gate = _gated_alphas(m2, cn, op, g, rng, px, py)
        for out, val in zip(outs, row_fn(alpha, gate, g)):
            out[p0:p1] = val
    return outs


def rasterize_num_contributing_gaussians_sparse(
    means2d, conics, opacities, pixels, image_ids,
    image_width, image_height, tile_size, isect_offsets, flatten_ids,
    n_isects, max_range,
):
    """(counts int32 [P], alphas [P]) at the requested pixels."""
    P, dev = pixels.shape[0], means2d.device
    outs = (torch.zeros(P, dtype=torch.int32, device=dev),
            torch.zeros(P, dtype=means2d.dtype, device=dev))
    return tuple(_sparse_map(_count_rows, means2d, conics, opacities, pixels, image_ids,
                             tile_size, isect_offsets, flatten_ids, n_isects, max_range, outs))


def rasterize_contributing_gaussian_ids_sparse(
    means2d, conics, opacities, pixels, image_ids,
    image_width, image_height, tile_size, isect_offsets, flatten_ids,
    n_isects, max_range, max_contributors,
):
    """(ids int32 [P, K] -1-padded front to back, weights [P, K])."""
    P, N, dev = pixels.shape[0], means2d.shape[1], means2d.device
    K = max_contributors
    outs = (torch.full((P, K), -1, dtype=torch.int32, device=dev),
            torch.zeros((P, K), dtype=means2d.dtype, device=dev))
    return tuple(_sparse_map(lambda a, gt, g: _id_rows(a, gt, g, N, K), means2d, conics,
                             opacities, pixels, image_ids, tile_size, isect_offsets, flatten_ids,
                             n_isects, max_range, outs))


def rasterize_top_contributing_gaussian_ids_sparse(
    means2d, conics, opacities, pixels, image_ids,
    image_width, image_height, tile_size, isect_offsets, flatten_ids,
    n_isects, max_range, num_depth_samples,
):
    """The top-k contributors by weight at the requested pixels, front to
    back."""
    P, N, dev = pixels.shape[0], means2d.shape[1], means2d.device
    k = num_depth_samples
    outs = (torch.full((P, k), -1, dtype=torch.int32, device=dev),
            torch.zeros((P, k), dtype=means2d.dtype, device=dev))
    return tuple(_sparse_map(lambda a, gt, g: _top_rows(a, gt, g, N, k), means2d, conics,
                             opacities, pixels, image_ids, tile_size, isect_offsets, flatten_ids,
                             n_isects, max_range, outs))
