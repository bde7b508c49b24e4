"""3DGS composite, forward (K1) and backward (K2): wrappers for
`csrc/rasterize_fwd.cu` and `csrc/rasterize_bwd.cu`.

K1 `rasterize_fwd` replaces gsplat_tpu/ops/rasterize_pallas.py:_fwd_kernel
(:330, wrapper _fwd_call :818); K2 `rasterize_bwd` replaces _bwd_kernel
(:475, wrapper _bwd_call :882).  On a CUDA tensor a wrapper launches its
kernel (or raises); the plain versions run only for CPU tensors.  Launches
are counted in `<wrapper>.launches`.

Semantics follow the JAX oracle (gsplat_tpu/ops/rasterize_ref.py:32-47) and
upstream gsplat: a pixel stops for good at the first gaussian that would
take its transmittance to <= 1e-4, and that gaussian is excluded.  The JAX
Pallas kernel can resume such a pixel in a later 256-slot chunk
(rasterize_pallas.py:409-431); that gap of the reference is not copied.
The backward replays the forward's decisions: the two CUDA kernels share
`csrc/composite.cuh` and the two plain versions share `_composite_batch`.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD

SIGMA_EPS_NEG = -2e-3  # the JAX kernels' tolerance for f32 noise at sigma ~ 0
MAX_CHANNELS = 32  # the kernel is instantiated for D in [1, 32]
# (tile, pixel, slot) elements per batch of the plain version
_PLAIN_BUDGET = 1 << 24


def _tile_batches(counts: torch.Tensor, n_pix: int,
                  budget: int = _PLAIN_BUDGET) -> Iterator[Tuple[int, int, int]]:
    """Consecutive tile ranges [t0, t1) whose padded work fits the budget;
    yields (t0, t1, longest span in the range)."""
    c = counts.tolist()
    t0 = 0
    while t0 < len(c):
        longest = max(c[t0], 1)
        t1 = t0 + 1
        while t1 < len(c):
            nxt = max(longest, c[t1], 1)
            if (t1 + 1 - t0) * n_pix * nxt > budget:
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


class _Batch(NamedTuple):
    """The composite of tiles [t0, t1) over their padded spans of L slots."""

    idx: torch.Tensor  # [nt, L] slot of each padded position (clamped)
    valid: torch.Tensor  # [nt, L] position lies inside the tile's span
    geom: Tuple[torch.Tensor, ...]  # (a, b, c) each [nt, 1, L]
    colors: torch.Tensor  # [D, nt, L]
    dx: torch.Tensor  # [nt, n_pix, L] pixel centre minus mean
    dy: torch.Tensor
    vis: torch.Tensor  # exp(-sigma)
    unclamped: torch.Tensor  # op * vis < 0.99
    alpha: torch.Tensor  # gated alpha (0 where gated)
    t_before: torch.Tensor  # transmittance before each slot
    live: torch.Tensor  # the pair contributes (kept by the gate, before the stop)
    weights: torch.Tensor  # alpha * t_before on live pairs, else 0
    t_final: torch.Tensor  # [nt, n_pix]
    evaluated: torch.Tensor  # [nt, n_pix] slots each pixel reads before it stops
    im: torch.Tensor  # [nt] image of each tile
    x: torch.Tensor  # [nt, n_pix] pixel column
    y: torch.Tensor  # [nt, n_pix] pixel row
    inside: torch.Tensor  # [nt, n_pix] pixel lies in the image


def _composite_batch(fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_per_image,
                     width, height) -> _Batch:
    """Replay tiles [t0, t1) front to back over their padded spans of L
    slots: the decisions (gate, stop) and weights both plain versions use."""
    dev = fields.device
    n_pix = tile * tile
    tiles = torch.arange(t0, t1, device=dev)
    j = torch.arange(L, device=dev)
    valid = j[None] < counts[t0:t1, None]  # [nt, L]
    idx = torch.clamp(starts[t0:t1, None] + j[None], max=max(fields.shape[1] - 1, 0))
    g = fields[:, idx]  # [F, nt, L]
    mx, my, a, b, c, op = (g[i][:, None, :] for i in range(6))

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
    vis = torch.exp(-sigma)
    raw = op * vis
    alpha = torch.clamp(raw, max=MAX_ALPHA)
    gate = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & valid[:, None, :]
    alpha = torch.where(gate, alpha, 0.0)

    t0_pix = inside.to(torch.float32)[..., None]  # T starts at 0 outside the image
    cp_incl = t0_pix * _serial_cumprod(1.0 - alpha)
    cp_excl = torch.cat([t0_pix, cp_incl[..., :-1]], dim=-1)
    contribute = cp_incl > TRANSMITTANCE_THRESHOLD
    t_final = torch.amin(torch.where(contribute, cp_incl, 1.0), dim=-1)
    return _Batch(
        idx=idx, valid=valid, geom=(a, b, c), colors=g[6:], dx=dx, dy=dy, vis=vis,
        unclamped=raw < MAX_ALPHA, alpha=alpha, t_before=cp_excl, live=gate & contribute,
        weights=alpha * cp_excl * contribute,
        t_final=torch.where(inside, t_final, 0.0),
        evaluated=((cp_excl > TRANSMITTANCE_THRESHOLD) & valid[:, None, :]).sum(-1),
        im=im, x=x, y=y, inside=inside,
    )


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
        cb = _composite_batch(
            fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_w * tiles_h, width, height
        )
        # a batched product over the slot axis (float32 matmul: TF32 is off
        # by default on the card, torch.backends.cuda.matmul.allow_tf32)
        pix = torch.einsum("tpl,dtl->tpd", cb.weights, cb.colors)
        inside = cb.inside
        at = (cb.im[:, None].expand_as(cb.x)[inside], cb.y[inside], cb.x[inside])
        out_c[at] = pix[inside]
        out_t[at] = cb.t_final[inside]
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
    pair_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite every tile front to back.

    Returns (colors [I, H, W, D] f32, T_final [I, H, W] f32).  On the card,
    `pair_counts` receives each tile's count of contributing (pixel, slot)
    pairs, which the backward's live pairs must equal.
    """
    D, n_tiles = _check_composite_args("rasterize_fwd", fields, bounds, n_images, tile,
                                       tiles_w, tiles_h)
    if not check_kernel_device("rasterize_fwd", fields, bounds):
        if pair_counts is not None:
            raise ValueError("pair_counts is filled by the CUDA kernel only")
        return rasterize_fwd_plain(fields, bounds, n_images, tile, tiles_w, tiles_h, width, height)
    lib = _build.load("rasterize_fwd")
    out_c = torch.empty((n_images, height, width, D), dtype=torch.float32, device=fields.device)
    out_t = torch.empty((n_images, height, width), dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize_fwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tile,
        tiles_w, tiles_w * tiles_h, width, height, n_tiles,
        out_c.data_ptr(), out_t.data_ptr(), _counts_ptr(pair_counts, n_tiles, fields.device),
        _build.stream_of(out_c),
    )
    _build.check(lib, code, "rasterize_fwd")
    rasterize_fwd.launches += 1
    return out_c, out_t


rasterize_fwd.launches = 0


def _check_composite_args(name, fields, bounds, n_images, tile, tiles_w, tiles_h):
    """Validate what K1 and K2 share; returns (D, n_tiles)."""
    if tile not in (8, 16, 32):
        raise ValueError(f"tile must be 8, 16 or 32, got {tile}")
    if fields.dim() != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous float32 [6+D, P] tensor")
    D = fields.shape[0] - 6
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"{name} takes 1 to {MAX_CHANNELS} channels, got D={D}")
    n_tiles = n_images * tiles_w * tiles_h
    if bounds.shape != (n_tiles + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [{n_tiles + 1}], got {bounds.dtype} {tuple(bounds.shape)}")
    return D, n_tiles


def _counts_ptr(counts: Optional[torch.Tensor], n_tiles: int, device) -> Optional[int]:
    if counts is None:
        return None
    if (counts.shape != (n_tiles,) or counts.dtype != torch.int32 or counts.device != device
            or not counts.is_contiguous()):
        raise ValueError(f"per-tile counts must be a contiguous int32 [{n_tiles}] tensor on {device}")
    return counts.data_ptr()


# ---------------------------------------------------------------------------
# K2: per-slot gradients at the sorted positions
# ---------------------------------------------------------------------------


def rasterize_bwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, n_images: int, tile: int,
    tiles_w: int, tiles_h: int, width: int, height: int,
    v_pix: torch.Tensor, v_t: torch.Tensor, pix_out: torch.Tensor, t_final: torch.Tensor,
) -> Tuple[torch.Tensor, int]:
    """Plain version of K2: the same replay as `rasterize_fwd_plain`
    (`_composite_batch`), then the per-pair gradient terms summed over each
    tile's pixels.  Returns (v_slot [6+D, P], live (pixel, slot) pairs)."""
    F, P = fields.shape
    n_tiles = n_images * tiles_w * tiles_h
    v_slot = torch.zeros((F, P), dtype=torch.float32, device=fields.device)
    starts = bounds[:-1].long()
    counts = (bounds[1:] - bounds[:-1]).long()
    n_live = 0
    for t0, t1, L in _tile_batches(counts[:n_tiles], tile * tile):
        cb = _composite_batch(
            fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_w * tiles_h, width, height
        )
        # pixels past the image edge read a clamped address and are never live
        at = (cb.im[:, None].expand_as(cb.x), cb.y.clamp(max=height - 1), cb.x.clamp(max=width - 1))
        vp = v_pix[at]  # [nt, n_pix, D]
        dtot = (vp * pix_out[at]).sum(-1, keepdim=True)
        vt_term = (v_t[at] * t_final[at])[..., None]
        a, b, c = cb.geom
        d = torch.einsum("tpd,dtl->tpl", vp, cb.colors)
        e_incl = torch.cumsum(cb.weights * d, dim=-1)
        ra = 1.0 / (1.0 - cb.alpha)  # alpha <= 0.99
        v_alpha = d * cb.t_before - (dtot - e_incl) * ra - vt_term * ra
        v_alpha = torch.where(cb.live & cb.unclamped, v_alpha, 0.0)
        v_sigma = -cb.alpha * v_alpha
        rows = [
            -(v_sigma * (a * cb.dx + b * cb.dy)).sum(1),
            -(v_sigma * (c * cb.dy + b * cb.dx)).sum(1),
            0.5 * (v_sigma * cb.dx * cb.dx).sum(1),
            (v_sigma * cb.dx * cb.dy).sum(1),
            0.5 * (v_sigma * cb.dy * cb.dy).sum(1),
            (cb.vis * v_alpha).sum(1),
        ]
        v_col = torch.einsum("tpd,tpl->dtl", vp, cb.weights)
        grads = torch.cat([torch.stack(rows), v_col])  # [F, nt, L]
        v_slot[:, cb.idx[cb.valid]] = grads[:, cb.valid]
        n_live += int(cb.live.sum())
    return v_slot, n_live


def rasterize_bwd(
    fields: torch.Tensor,  # [6+D, P] f32 sorted slot rows, as the forward read them
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans
    n_images: int,
    tile: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
    v_pix: torch.Tensor,  # [I, H, W, D] cotangent of the forward's colors
    v_t: torch.Tensor,  # [I, H, W] cotangent of the forward's T_final
    pix_out: torch.Tensor,  # [I, H, W, D] the forward's colors
    t_final: torch.Tensor,  # [I, H, W] the forward's T_final
    live_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
) -> torch.Tensor:
    """Per-slot gradients of (x, y, a, b, c, opacity, colors) at the sorted
    positions, [6+D, P] f32; slots outside every span are zero.  The same
    inputs give the same bits from run to run.  On the card, `live_counts`
    receives each tile's count of live (pixel, slot) pairs."""
    D, n_tiles = _check_composite_args("rasterize_bwd", fields, bounds, n_images, tile,
                                       tiles_w, tiles_h)
    for name, t, shape in (("v_pix", v_pix, (n_images, height, width, D)),
                           ("v_t", v_t, (n_images, height, width)),
                           ("pix_out", pix_out, (n_images, height, width, D)),
                           ("t_final", t_final, (n_images, height, width))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not check_kernel_device("rasterize_bwd", fields, bounds, v_pix, v_t, pix_out, t_final):
        if live_counts is not None:
            raise ValueError("live_counts is filled by the CUDA kernel only")
        return rasterize_bwd_plain(fields, bounds, n_images, tile, tiles_w, tiles_h, width,
                                   height, v_pix, v_t, pix_out, t_final)[0]
    lib = _build.load("rasterize_bwd")
    v_slot = torch.zeros(fields.shape, dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize_bwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tile,
        tiles_w, tiles_w * tiles_h, width, height, n_tiles,
        v_pix.data_ptr(), v_t.data_ptr(), pix_out.data_ptr(), t_final.data_ptr(),
        v_slot.data_ptr(), _counts_ptr(live_counts, n_tiles, fields.device),
        _build.stream_of(v_slot),
    )
    _build.check(lib, code, "rasterize_bwd")
    rasterize_bwd.launches += 1
    return v_slot


rasterize_bwd.launches = 0
