"""Contributing-gaussian analysis ops and the iterative index rasterization.

Port of `gsplat_tpu/ops/contributing.py:33-391`:
rasterize_num_contributing_gaussians, rasterize_contributing_gaussian_ids,
rasterize_top_contributing_gaussian_ids, rasterize_to_indices_in_range,
accumulate and rasterize_to_indices_in_range_2dgs.  They walk the dense
per-pixel worklist by bands, as the oracle does (ops/rasterize_ref.py),
with the kernels' semantics of "contributing": the sigma and alpha gates,
the MAX_ALPHA clamp, the transmittance cutoff with the saturating gaussian
excluded, the transmittance a serial float32 product.

Where the JAX function keeps a static shape, so does the port:
`rasterize_to_indices_in_range` returns [I*H*W*(range_end - range_start) *
tile_size^2] arrays in ray-major order with a `valid` mask.  The top-k
selection is a stable descending sort, so ties go to the front slot, as
`jax.lax.top_k` gives them, on both devices.

`accumulate` keeps the nerfacc semantics its name promises: each ray's
transmittance is the exclusive product within its own run of entries.  The
JAX function takes it from one float32 log-space cumsum over the whole
list, re-based at each ray's start, whose resolution is that of the
running prefix and falls as the list grows (a fault of the reference,
ROADMAP Queue 3).  Here the cumsum restarts with every chunk of the list
and runs in float64, and each run's sums go through K5
(`segsum_kernel.segment_rowsum`) in entry order: deterministic, no atomics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .projection import MAX_ALPHA
from .rasterize2d_ref import _surfel_alphas
from .rasterize_ref import (
    _dense_bands,
    _gated_alphas,
    _put_pixels,
    _slot_ids,
    _span_bounds,
    _weights_from_alphas,
)
from .segsum_kernel import segment_rowsum

_INT32_MAX = 2**31 - 1
# list entries `accumulate` takes at once
_ACC_CHUNK = 1 << 25


def _count_rows(alpha, gate, g=None):
    """(contributing count int32, accumulated alpha) of each row."""
    _, contribute, t_final = _weights_from_alphas(alpha)
    return (gate & contribute).sum(-1).to(torch.int32), 1.0 - t_final


def _id_rows(alpha, gate, g, N: int, K: int):
    """The first K contributing slots of each row, front to back: (ids
    int32 [..., K] of gaussian g % N, -1 past the last; weights, 0 there)."""
    weights, contribute, _ = _weights_from_alphas(alpha)
    live = gate & contribute
    pos = torch.cumsum(live, dim=-1) - 1
    col = torch.where(live & (pos < K), pos, K)  # column K collects the rest
    shape = live.shape[:-1] + (K + 1,)
    gid = torch.where(live, g % N, -1).expand(live.shape)
    ids = torch.full(shape, -1, dtype=torch.int64, device=alpha.device).scatter_(-1, col, gid)
    w = torch.zeros(shape, dtype=weights.dtype, device=alpha.device).scatter_(
        -1, col, torch.where(live, weights, 0.0))
    return ids[..., :K].to(torch.int32), w[..., :K]


def _top_rows(alpha, gate, g, N: int, k: int):
    """The k contributing slots of each row with the largest weights (ties:
    the front slot first), front to back; ids -1 and weights 0 padded."""
    weights, contribute, _ = _weights_from_alphas(alpha)
    live = gate & contribute
    w = torch.where(live, weights, -1.0)
    g = g.expand(w.shape)
    if w.shape[-1] < k:  # fewer slots than k: the rest are not contributing
        pad = k - w.shape[-1]
        w = torch.cat([w, w.new_full(w.shape[:-1] + (pad,), -1.0)], dim=-1)
        g = torch.cat([g, g.new_zeros(g.shape[:-1] + (pad,))], dim=-1)
    vals, idx = torch.sort(w, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :k], idx[..., :k]
    order = torch.sort(torch.where(topw > 0.0, topi, _INT32_MAX), dim=-1, stable=True).indices
    topi = torch.gather(topi, -1, order)
    topw = torch.gather(topw, -1, order)
    sel = torch.gather(g, -1, topi)
    valid = topw > 0.0
    return torch.where(valid, sel % N, -1).to(torch.int32), torch.where(valid, topw, 0.0)


def _dense_map(row_fn, means2d, conics, opacities, tile_offsets, flatten_ids, n_isects,
               image_width, image_height, tile_size, max_range, outs):
    """row_fn(alpha, gate, g) on every band of the image; its outputs are
    written to `outs` ([I, H, W, ...] each) at the band's pixels."""
    I, N = means2d.shape[0], means2d.shape[1]
    m2 = means2d.reshape(I * N, 2)
    cn = conics.reshape(I * N, 3)
    op = opacities.reshape(I * N)
    for band in _dense_bands(tile_offsets, flatten_ids, n_isects, tile_size, image_width,
                             image_height, 0, max_range):
        alpha, gate = _gated_alphas(m2, cn, op, band.g, band.in_range, band.px, band.py)
        for out, val in zip(outs, row_fn(alpha, gate, band.g)):
            _put_pixels(out, band, val)
    return outs


def rasterize_num_contributing_gaussians(
    means2d: torch.Tensor,  # [I, N, 2]
    conics: torch.Tensor,  # [I, N, 3]
    opacities: torch.Tensor,  # [I, N]
    tile_offsets: torch.Tensor,  # [I, th, tw]
    flatten_ids: torch.Tensor,  # [P]
    image_width: int,
    image_height: int,
    tile_size: int,
    n_isects: torch.Tensor,
    max_range: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts int32 [I,H,W], accumulated alphas [I,H,W])."""
    I, dev = means2d.shape[0], means2d.device
    counts = torch.zeros((I, image_height, image_width), dtype=torch.int32, device=dev)
    alphas = torch.zeros((I, image_height, image_width), dtype=means2d.dtype, device=dev)
    return tuple(_dense_map(_count_rows, means2d, conics, opacities, tile_offsets, flatten_ids,
                            n_isects, image_width, image_height, tile_size, max_range,
                            (counts, alphas)))


def rasterize_contributing_gaussian_ids(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    tile_offsets: torch.Tensor,
    flatten_ids: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_size: int,
    n_isects: torch.Tensor,
    max_range: int,
    max_contributors: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [I,H,W,K] -1-padded front to back, weights [I,H,W,K]);
    K = `max_contributors`, e.g. the largest count of
    `rasterize_num_contributing_gaussians`."""
    I, N, dev = means2d.shape[0], means2d.shape[1], means2d.device
    K = max_contributors
    ids = torch.full((I, image_height, image_width, K), -1, dtype=torch.int32, device=dev)
    w = torch.zeros((I, image_height, image_width, K), dtype=means2d.dtype, device=dev)
    return tuple(_dense_map(lambda a, gt, g: _id_rows(a, gt, g, N, K), means2d, conics,
                            opacities, tile_offsets, flatten_ids, n_isects, image_width,
                            image_height, tile_size, max_range, (ids, w)))


def rasterize_top_contributing_gaussian_ids(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    tile_offsets: torch.Tensor,
    flatten_ids: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_size: int,
    n_isects: torch.Tensor,
    max_range: int,
    num_depth_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-`num_depth_samples` contributors of each pixel by weight
    alpha * T, front to back; ids -1 and weights 0 padded."""
    I, N, dev = means2d.shape[0], means2d.shape[1], means2d.device
    k = num_depth_samples
    ids = torch.full((I, image_height, image_width, k), -1, dtype=torch.int32, device=dev)
    w = torch.zeros((I, image_height, image_width, k), dtype=means2d.dtype, device=dev)
    return tuple(_dense_map(lambda a, gt, g: _top_rows(a, gt, g, N, k), means2d, conics,
                            opacities, tile_offsets, flatten_ids, n_isects, image_width,
                            image_height, tile_size, max_range, (ids, w)))


def _indices_in_range(alpha_fn, range_start: int, range_end: int, transmittances, I: int,
                      N: int, image_width: int, image_height: int, tile_size: int,
                      isect_offsets, flatten_ids, n_isects):
    """The static-shape (gaussian, pixel, image, valid) lists of slots
    [range_start, range_end) in blocks of tile_size^2, ray-major;
    alpha_fn(g, in_range, px, py) gives the gated alphas and the gate."""
    block = tile_size * tile_size
    r0, r1 = range_start * block, range_end * block
    R = r1 - r0
    th, tw = isect_offsets.shape[-2], isect_offsets.shape[-1]
    H, W = image_height, image_width
    dev = isect_offsets.device
    valid = torch.zeros((I, H, W, R), dtype=torch.bool, device=dev)
    # every (pixel, slot)'s gaussian, in range or not, as the JAX function's
    bounds = _span_bounds(isect_offsets, n_isects)
    g_tile, _ = _slot_ids(bounds, flatten_ids, torch.arange(I * th * tw, device=dev), r0, R)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    tile_pix = ((torch.arange(I, device=dev) * (th * tw))[:, None, None]
                + ((ys // tile_size) * tw)[None, :, None] + (xs // tile_size)[None, None, :])
    gaussian_ids = (g_tile % N).to(torch.int32)[tile_pix].reshape(-1)
    del g_tile, tile_pix
    if R > 0:
        for band in _dense_bands(isect_offsets, flatten_ids, n_isects, tile_size, W, H, r0, r1):
            alpha, gate = alpha_fn(band.g, band.in_range, band.px, band.py)
            m = band.inside
            t0 = torch.ones(m.shape, dtype=alpha.dtype, device=dev)
            t0[m] = transmittances[band.im[m], band.y[m], band.x[m]].to(alpha.dtype)
            _, contribute, _ = _weights_from_alphas(alpha, t0=t0)
            live = gate & contribute
            valid[band.im[m], band.y[m], band.x[m], : band.L] = live[m]
    pixel_ids = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W, 1)
    image_ids = torch.arange(I, dtype=torch.int32, device=dev).reshape(I, 1, 1, 1)
    return (gaussian_ids, pixel_ids.expand(I, H, W, R).reshape(-1),
            image_ids.expand(I, H, W, R).reshape(-1), valid.reshape(-1))


def rasterize_to_indices_in_range(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [I, H, W]
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,
    flatten_ids: torch.Tensor,
    n_isects: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contributing (gaussian, pixel, image) triplets of worklist slots
    [range_start, range_end), in units of tile_size^2 slots, given each
    pixel's transmittance so far.  Returns (gaussian_ids, pixel_ids,
    image_ids, valid), each of I*H*W*(range_end-range_start)*tile_size^2
    entries in ray-major order (compose with `accumulate`)."""
    I, N = means2d.shape[0], means2d.shape[1]
    m2 = means2d.reshape(I * N, 2)
    cn = conics.reshape(I * N, 3)
    op = opacities.reshape(I * N)
    return _indices_in_range(
        lambda g, rng, px, py: _gated_alphas(m2, cn, op, g, rng, px, py),
        range_start, range_end, transmittances, I, N, image_width, image_height, tile_size,
        isect_offsets, flatten_ids, n_isects)


def _run_sums(data: torch.Tensor, starts: torch.Tensor, n: int) -> torch.Tensor:
    """K5 sums [F, runs] of data [F, n] over the runs starting at `starts`."""
    bounds = torch.cat([starts, starts.new_full((1,), n)]).to(torch.int32)
    return segment_rowsum(data.contiguous(), bounds)


def accumulate(
    means2d: torch.Tensor,  # [I, N, 2]
    conics: torch.Tensor,  # [I, N, 3]
    opacities: torch.Tensor,  # [I, N]
    colors: torch.Tensor,  # [I, N, D]
    gaussian_ids: torch.Tensor,  # [M]
    pixel_ids: torch.Tensor,  # [M]
    image_ids: torch.Tensor,  # [M]
    valid: torch.Tensor,  # [M] bool
    image_width: int,
    image_height: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alpha compositing of the given intersections, front to back within
    each ray's run of entries: [I,H,W,D] colors and [I,H,W,1] alphas.  A
    run is a maximal stretch of equal (image, pixel); its transmittance
    starts at 1.  The `valid` mask replaces nerfacc's packed layout."""
    I, N, D = colors.shape[0], colors.shape[1], colors.shape[2]
    HW = image_height * image_width
    dev = means2d.device
    m2 = means2d.reshape(I * N, 2)
    cn = conics.reshape(I * N, 3)
    op = opacities.reshape(I * N)
    cl = colors.reshape(I * N, D)
    M = gaussian_ids.shape[0]
    run_rays, run_sums = [], []
    carry_ray, carry_log = None, None
    for a in range(0, M, _ACC_CHUNK):
        b = min(a + _ACC_CHUNK, M)
        ray = image_ids[a:b].long() * HW + pixel_ids[a:b].long()
        pix = pixel_ids[a:b].long()
        gid = image_ids[a:b].long() * N + gaussian_ids[a:b].long()
        px = (pix % image_width).to(means2d.dtype) + 0.5
        py = torch.div(pix, image_width, rounding_mode="floor").to(means2d.dtype) + 0.5
        dx = m2[gid, 0] - px
        dy = m2[gid, 1] - py
        sigma = 0.5 * (cn[gid, 0] * dx * dx + cn[gid, 2] * dy * dy) + cn[gid, 1] * dx * dy
        alpha = torch.clamp(op[gid] * torch.exp(-sigma), max=MAX_ALPHA)
        alpha = torch.where(valid[a:b], alpha, 0.0)
        del dx, dy, sigma
        # each run's exclusive transmittance: a float64 cumsum of log(1 - alpha)
        # within the chunk, re-based at the run's start (or carried over)
        log1m = torch.log1p(-alpha.double())
        ex = torch.cumsum(log1m, 0) - log1m
        first = torch.ones(1, dtype=torch.bool, device=dev) if carry_ray is None else (
            ray[:1] != carry_ray)
        is_start = torch.cat([first, ray[1:] != ray[:-1]])
        run = torch.cumsum(is_start, 0) - is_start[0].long()
        starts = torch.nonzero(is_start)[:, 0]
        base = ex[starts]
        if not bool(is_start[0]):  # the first run goes on from the last chunk
            starts = torch.cat([starts.new_zeros(1), starts])
            base = torch.cat([-carry_log.reshape(1), base])
        trans = torch.exp(ex - base[run]).to(alpha.dtype)
        weights = alpha * trans
        data = torch.cat([weights[None] * cl[gid].t(), weights[None]])
        run_sums.append(_run_sums(data, starts, b - a))
        run_rays.append(ray[starts])
        carry_ray = ray[-1:]
        carry_log = log1m[-1] + ex[-1] - base[-1]
        del log1m, ex, trans, weights, data, alpha
    out = torch.zeros((D + 1, I * HW), dtype=colors.dtype, device=dev)
    if M:
        # a ray of several runs (one cut by a chunk, or runs apart) adds them
        # in list order: a stable sort by ray, then K5 once more
        rays = torch.cat(run_rays)
        sums = torch.cat(run_sums, dim=1)
        rays_s, order = torch.sort(rays, stable=True)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), rays_s[1:] != rays_s[:-1]])
        starts = torch.nonzero(first)[:, 0]
        out[:, rays_s[starts]] = _run_sums(sums[:, order], starts, rays_s.shape[0])
    render = out[:D].t().reshape(I, image_height, image_width, D)
    alphas = out[D].reshape(I, image_height, image_width, 1)
    return render, alphas


def rasterize_to_indices_in_range_2dgs(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [I, H, W]
    means2d: torch.Tensor,  # [I, N, 2]
    ray_transforms: torch.Tensor,  # [I, N, 3, 3] (or [I, N, 9])
    opacities: torch.Tensor,  # [I, N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,
    flatten_ids: torch.Tensor,
    n_isects: torch.Tensor,
):
    """2DGS counterpart of `rasterize_to_indices_in_range`: the same
    static-shape (ids, pixel, image, valid) contract with the surfel
    response."""
    I, N = means2d.shape[0], means2d.shape[1]
    m2 = means2d.reshape(I * N, 2)
    Mt = ray_transforms.reshape(I * N, 9)
    op = opacities.reshape(I * N)
    return _indices_in_range(
        lambda g, rng, px, py: _surfel_alphas(m2, Mt, op, g, rng, px, py),
        range_start, range_end, transmittances, I, N, image_width, image_height, tile_size,
        isect_offsets, flatten_ids, n_isects)
