"""3DGS forward composite (K1): wrapper for `csrc/rasterize_fwd.cu`.

Replaces gsplat_tpu/ops/rasterize_pallas.py:_fwd_kernel (:330, wrapper
_fwd_call :818).  On a CUDA tensor the wrapper launches the kernel (or
raises); the plain version runs only for CPU tensors.  Launches are
counted in `rasterize_fwd.launches`.

Semantics follow the JAX oracle (gsplat_tpu/ops/rasterize_ref.py:32-47) and
upstream gsplat: a pixel stops for good at the first gaussian that would
take its transmittance to <= 1e-4, and that gaussian is excluded.  The JAX
Pallas kernel can resume such a pixel in a later 256-slot chunk
(rasterize_pallas.py:409-431); that gap of the reference is not copied.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD

SIGMA_EPS_NEG = -2e-3  # the JAX kernels' tolerance for f32 noise at sigma ~ 0
MAX_CHANNELS = 32  # the kernel is instantiated for D in [1, 32]
# (tile, pixel, slot) elements per batch of the plain version
_PLAIN_BUDGET = 1 << 24


def _tile_batches(counts: torch.Tensor, n_pix: int) -> Iterator[Tuple[int, int, int]]:
    """Consecutive tile ranges [t0, t1) whose padded work fits the budget;
    yields (t0, t1, longest span in the range)."""
    c = counts.tolist()
    t0 = 0
    while t0 < len(c):
        longest = max(c[t0], 1)
        t1 = t0 + 1
        while t1 < len(c):
            nxt = max(longest, c[t1], 1)
            if (t1 + 1 - t0) * n_pix * nxt > _PLAIN_BUDGET:
                break
            longest = nxt
            t1 += 1
        yield t0, t1, longest
        t0 = t1


def _serial_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last axis, one float32 factor at a time,
    front to back: the kernel's T *= 1 - alpha.  torch.cumprod rounds in
    another order (a parallel scan on the card, double on the CPU), and the
    stop rule at T <= 1e-4 turns one ulp of T into a whole gaussian's weight."""
    xs = x.movedim(-1, 0).contiguous()
    out = torch.empty_like(xs)
    acc = xs[0]
    out[0] = acc
    for j in range(1, xs.shape[0]):
        acc = acc * xs[j]
        out[j] = acc
    return out.movedim(0, -1)


def _composite_batch(fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_per_image,
                     width, height):
    """Alpha weights of tiles [t0, t1) over their padded spans of L slots.

    Returns (weights [nt, n_pix, L], colors [D, nt, L], t_final [nt, n_pix],
    evaluated [nt, n_pix] slots each pixel reads before it stops) plus the
    pixels' (im, x, y, inside).
    """
    dev = fields.device
    n_pix = tile * tile
    tiles = torch.arange(t0, t1, device=dev)
    j = torch.arange(L, device=dev)
    valid = j[None] < counts[t0:t1, None]  # [nt, L]
    idx = torch.clamp(starts[t0:t1, None] + j[None], max=max(fields.shape[1] - 1, 0))
    g = fields[:, idx]  # [F, nt, L]
    mx, my, a, b, c, op = (g[i][:, None, :] for i in range(6))
    colors = g[6:]

    im = tiles // tiles_per_image
    tl = tiles % tiles_per_image
    p = torch.arange(n_pix, device=dev)
    x = (tl % tiles_w)[:, None] * tile + (p % tile)[None]
    y = (tl // tiles_w)[:, None] * tile + (p // tile)[None]
    inside = (x < width) & (y < height)  # [nt, n_pix]
    px = (x.to(torch.float32) + 0.5)[..., None]
    py = (y.to(torch.float32) + 0.5)[..., None]

    dx = px - mx
    dy = py - my
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    sigma = torch.where(sigma >= SIGMA_EPS_NEG, torch.clamp(sigma, min=0.0), sigma)
    alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
    gate = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & valid[:, None, :]
    alpha = torch.where(gate, alpha, 0.0)

    t0_pix = inside.to(torch.float32)[..., None]  # T starts at 0 outside the image
    cp_incl = t0_pix * _serial_cumprod(1.0 - alpha)
    cp_excl = torch.cat([t0_pix, cp_incl[..., :-1]], dim=-1)
    contribute = cp_incl > TRANSMITTANCE_THRESHOLD
    weights = alpha * cp_excl * contribute
    t_final = torch.amin(torch.where(contribute, cp_incl, 1.0), dim=-1)
    t_final = torch.where(inside, t_final, 0.0)
    evaluated = ((cp_excl > TRANSMITTANCE_THRESHOLD) & valid[:, None, :]).sum(-1)
    return weights, colors, t_final, evaluated, (im, x, y, inside)


def rasterize_fwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, n_images: int, tile: int,
    tiles_w: int, tiles_h: int, width: int, height: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: per tile over a padded span, with a serial
    cumulative product and the stop mask, in batches of tiles of bounded
    size."""
    D = fields.shape[0] - 6
    n_tiles = n_images * tiles_w * tiles_h
    out_c = torch.zeros((n_images, height, width, D), dtype=torch.float32, device=fields.device)
    out_t = torch.zeros((n_images, height, width), dtype=torch.float32, device=fields.device)
    starts = bounds[:-1].long()
    counts = (bounds[1:] - bounds[:-1]).long()
    for t0, t1, L in _tile_batches(counts[:n_tiles], tile * tile):
        w, colors, t_final, _, (im, x, y, inside) = _composite_batch(
            fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_w * tiles_h, width, height
        )
        # a batched product over the slot axis (float32 matmul: TF32 is off
        # by default on the card, torch.backends.cuda.matmul.allow_tf32)
        pix = torch.einsum("tpl,dtl->tpd", w, colors)
        at = (im[:, None].expand_as(x)[inside], y[inside], x[inside])
        out_c[at] = pix[inside]
        out_t[at] = t_final[inside]
    return out_c, out_t


def rasterize_fwd(
    fields: torch.Tensor,  # [6+D, P] f32 sorted slot rows (x, y, a, b, c, op, colors)
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans in the sorted stream
    n_images: int,
    tile: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite every tile front to back.

    Returns (colors [I, H, W, D] f32, T_final [I, H, W] f32).
    """
    if tile not in (8, 16, 32):
        raise ValueError(f"tile must be 8, 16 or 32, got {tile}")
    if fields.dim() != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous float32 [6+D, P] tensor")
    D = fields.shape[0] - 6
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"rasterize_fwd takes 1 to {MAX_CHANNELS} channels, got D={D}")
    n_tiles = n_images * tiles_w * tiles_h
    if bounds.shape != (n_tiles + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [{n_tiles + 1}], got {bounds.dtype} {tuple(bounds.shape)}")
    if not check_kernel_device("rasterize_fwd", fields, bounds):
        return rasterize_fwd_plain(fields, bounds, n_images, tile, tiles_w, tiles_h, width, height)
    lib = _build.load("rasterize_fwd")
    out_c = torch.empty((n_images, height, width, D), dtype=torch.float32, device=fields.device)
    out_t = torch.empty((n_images, height, width), dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize_fwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tile,
        tiles_w, tiles_w * tiles_h, width, height, n_tiles,
        out_c.data_ptr(), out_t.data_ptr(), _build.stream_of(out_c),
    )
    _build.check(lib, code, "rasterize_fwd")
    rasterize_fwd.launches += 1
    return out_c, out_t


rasterize_fwd.launches = 0
