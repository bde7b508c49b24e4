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

Any channel count: the kernels composite 1 to MAX_CHANNELS channels, and
the wrappers take more in groups of MAX_CHANNELS (`channel_groups`), as
upstream gsplat's `channel_chunk` does, on the card and on the CPU alike.
Each group carries the geometry rows (x, y, a, b, c, op) with its colours.
Gate, stop and T depend on the geometry only, so every group makes the same
decisions, and a grouped forward is a single pass's, bit for bit: colours
concatenated, T from the first group.  The backward is linear in the colour
cotangents; each group gets its own and v_T goes to the first group only
(the others take zeros), the geometry rows' gradients are added over the
groups in float32 in group order, and each group's colour rows go to its
channels.

Packed modes (rasterize_pallas.py `packed=True`, :399-407, :613-624, and
`pack_grads`, :690-709): with `packed` the slot stream is the bf16-pair
payload of the packed emission (ops/bf16pair.py: packed_rows(D) carriers,
means in tile-local pixels), which both kernels unpack and composite with
tile-local pixel centres; D then comes from `n_channels`, since the row
count does not give it.  With `pack_grads` the backward writes its 6+D
per-slot sums as grad_pack_rows(D) carriers.  Launches in a packed mode
count in `<wrapper>.launches_packed`.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .bf16pair import grad_pack_rows, pack_rows, packed_rows, unpack_payload
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD

SIGMA_EPS_NEG = -2e-3  # the JAX kernels' tolerance for f32 noise at sigma ~ 0
MAX_CHANNELS = 32  # the kernels are instantiated for D in [1, 32]; wrappers group more
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


def tile_sets(bounds: torch.Tensor, n_tiles: int, n_pix: int, tiles: Optional[torch.Tensor] = None,
              budget: int = _PLAIN_BUDGET) -> Iterator[Tuple[torch.Tensor, int]]:
    """(tile ids, longest span) per batch of the tiles `tiles` (all when
    None), in the given order, whose padded work fits `budget` elements."""
    counts = (bounds[1:] - bounds[:-1]).long()
    ids = torch.arange(n_tiles, device=bounds.device) if tiles is None else tiles.long()
    for i0, i1, L in _tile_batches(counts[ids], n_pix, budget):
        yield ids[i0:i1], L


def _serial_colour_sum(weights: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """sum_l weights[t, p, l] * colors[:, t, l] -> [nt, n_pix, D], one float32
    product and one float32 add at a time, front to back: the kernel's
    accumulation.  A batched product over the slots rounds in another order
    (a matrix-vector product at D = 1 differed in the last bit)."""
    cols = colors.permute(1, 2, 0)  # [nt, L, D]
    acc = torch.zeros(weights.shape[:2] + (cols.shape[-1],), dtype=weights.dtype,
                      device=weights.device)
    for j in range(weights.shape[-1]):
        acc = acc + weights[:, :, j, None] * cols[:, None, j, :]
    return acc


class _Batch(NamedTuple):
    """The composite of a batch of tiles over their padded spans of L slots."""

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


def _composite_batch(fields, bounds, tiles, L, tile, tiles_w, tiles_per_image, width, height,
                     n_channels: Optional[int] = None) -> _Batch:
    """Replay the tiles `tiles` front to back over their padded spans of L
    slots: the decisions (gate, stop) and weights both plain versions use.
    With `n_channels` the fields are the packed payload of that many
    channels: unpacked, and composited with tile-local pixel centres."""
    dev = fields.device
    n_pix = tile * tile
    starts = bounds[:-1].long()[tiles]
    counts = (bounds[1:] - bounds[:-1]).long()[tiles]
    j = torch.arange(L, device=dev)
    valid = j[None] < counts[:, None]  # [nt, L]
    idx = torch.clamp(starts[:, None] + j[None], max=max(fields.shape[1] - 1, 0))
    g = fields[:, idx]  # [F, nt, L]
    packed = n_channels is not None
    if packed:
        g = unpack_payload(g, n_channels)
    mx, my, a, b, c, op = (g[i][:, None, :] for i in range(6))

    im = tiles // tiles_per_image
    tl = tiles % tiles_per_image
    p = torch.arange(n_pix, device=dev)
    x = (tl % tiles_w)[:, None] * tile + (p % tile)[None]
    y = (tl // tiles_w)[:, None] * tile + (p // tile)[None]
    inside = (x < width) & (y < height)  # [nt, n_pix]
    # packed: tile-local centres, as the packed means are tile-local
    px = ((p % tile).expand_as(x) if packed else x).to(torch.float32)[..., None] + 0.5
    py = ((p // tile).expand_as(y) if packed else y).to(torch.float32)[..., None] + 0.5

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


def _channel_count(name, fields, packed: bool, n_channels: Optional[int]) -> int:
    """D of the slot rows: 6+D float32 rows, or with `packed` the
    packed_rows(n_channels) carriers of the packed payload."""
    if not packed:
        return fields.shape[0] - 6
    if n_channels is None or fields.shape[0] != packed_rows(n_channels):
        raise ValueError(f"{name}: a packed payload needs n_channels with "
                         f"packed_rows(n_channels) == {fields.shape[0]} rows, got {n_channels}")
    return n_channels


def channel_groups(n_channels: int) -> List[Tuple[int, int]]:
    """[c0, c1) of each group of at most MAX_CHANNELS channels, in order: the
    launches a wrapper makes for `n_channels` channels."""
    return [(c0, min(c0 + MAX_CHANNELS, n_channels)) for c0 in range(0, n_channels, MAX_CHANNELS)]


def _group_fields(fields: torch.Tensor, c0: int, c1: int, packed: bool) -> torch.Tensor:
    """The slot rows of channels [c0, c1) with the geometry rows: float32
    rows 0-5 and 6+c0..6+c1, or the packed payload's 3 geometry carriers and
    the colour carriers of those channels (c0 is even, so a group falls on
    whole carriers; an odd last channel's carrier holds a zero low half)."""
    if packed:
        return torch.cat([fields[:3], fields[3 + c0 // 2 : 3 + (c1 + 1) // 2]])
    return torch.cat([fields[:6], fields[6 + c0 : 6 + c1]])


def rasterize_fwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, n_images: int, tile: int,
    tiles_w: int, tiles_h: int, width: int, height: int, packed: bool = False,
    n_channels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: per tile over a padded span, with a serial
    cumulative product, the stop mask and a serial colour sum, in batches of
    tiles of bounded size."""
    D = _channel_count("rasterize_fwd_plain", fields, packed, n_channels)
    n_tiles = n_images * tiles_w * tiles_h
    out_c = torch.zeros((n_images, height, width, D), dtype=torch.float32, device=fields.device)
    out_t = torch.zeros((n_images, height, width), dtype=torch.float32, device=fields.device)
    for ids, L in tile_sets(bounds, n_tiles, tile * tile):
        cb = _composite_batch(fields, bounds, ids, L, tile, tiles_w, tiles_w * tiles_h, width,
                              height, D if packed else None)
        pix = _serial_colour_sum(cb.weights, cb.colors)
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
    packed: bool = False,
    n_channels: Optional[int] = None,  # D, with `packed`
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite every tile front to back.

    Returns (colors [I, H, W, D] f32, T_final [I, H, W] f32).  On the card,
    `pair_counts` receives each tile's count of contributing (pixel, slot)
    pairs, which the backward's live pairs must equal.  With `packed` the
    fields are the packed payload [packed_rows(D), P] of D = n_channels.
    More than MAX_CHANNELS channels composite in `channel_groups`, the
    counts and T from the first.
    """
    D, n_tiles = _check_composite_args("rasterize_fwd", fields, bounds, n_images, tile,
                                       tiles_w, tiles_h, packed, n_channels)
    if D > MAX_CHANNELS:
        outs = [rasterize_fwd(_group_fields(fields, c0, c1, packed), bounds, n_images, tile,
                              tiles_w, tiles_h, width, height,
                              pair_counts if c0 == 0 else None, packed, c1 - c0)
                for c0, c1 in channel_groups(D)]
        return torch.cat([o[0] for o in outs], dim=-1), outs[0][1]
    if not check_kernel_device("rasterize_fwd", fields, bounds):
        if pair_counts is not None:
            raise ValueError("pair_counts is filled by the CUDA kernel only")
        return rasterize_fwd_plain(fields, bounds, n_images, tile, tiles_w, tiles_h, width, height,
                                   packed, n_channels)
    lib = _build.load("rasterize_fwd")
    out_c = torch.empty((n_images, height, width, D), dtype=torch.float32, device=fields.device)
    out_t = torch.empty((n_images, height, width), dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize_fwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tile,
        tiles_w, tiles_w * tiles_h, width, height, n_tiles, int(packed),
        out_c.data_ptr(), out_t.data_ptr(), _counts_ptr(pair_counts, n_tiles, fields.device),
        _build.stream_of(out_c),
    )
    _build.check(lib, code, "rasterize_fwd")
    if packed:
        rasterize_fwd.launches_packed += 1
    else:
        rasterize_fwd.launches += 1
    return out_c, out_t


rasterize_fwd.launches = 0
rasterize_fwd.launches_packed = 0


def _check_composite_args(name, fields, bounds, n_images, tile, tiles_w, tiles_h,
                          packed=False, n_channels=None):
    """Validate what K1 and K2 share; returns (D, n_tiles)."""
    if tile not in (8, 16, 32):
        raise ValueError(f"tile must be 8, 16 or 32, got {tile}")
    if fields.dim() != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous float32 [6+D, P] tensor")
    D = _channel_count(name, fields, packed, n_channels)
    if D < 1:
        raise ValueError(f"{name} takes at least one channel, got D={D}")
    n_tiles = n_images * tiles_w * tiles_h
    if bounds.shape != (n_tiles + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [{n_tiles + 1}], got {bounds.dtype} {tuple(bounds.shape)}")
    return D, n_tiles


def _add_groups(parts: List[torch.Tensor], n_rows: int) -> torch.Tensor:
    """The first `n_rows` rows of the channel groups' per-slot gradients
    (the geometry rows), added in float32 in group order."""
    total = parts[0][:n_rows].clone()
    for p in parts[1:]:
        total += p[:n_rows]
    return total


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
    packed: bool = False, pack_grads: bool = False, n_channels: Optional[int] = None,
    tiles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Plain version of K2: the same replay as `rasterize_fwd_plain`
    (`_composite_batch`), then the per-pair gradient terms summed over each
    tile's pixels.  Returns (v_slot [6+D, P], or its grad_pack_rows(D)
    carriers with `pack_grads`; live (pixel, slot) pairs).  With `tiles`
    (tile ids) only their slots are computed; the others keep zeros."""
    D = _channel_count("rasterize_bwd_plain", fields, packed, n_channels)
    P = fields.shape[1]
    n_tiles = n_images * tiles_w * tiles_h
    v_slot = torch.zeros((6 + D, P), dtype=torch.float32, device=fields.device)
    n_live = 0
    for ids, L in tile_sets(bounds, n_tiles, tile * tile, tiles):
        cb = _composite_batch(fields, bounds, ids, L, tile, tiles_w, tiles_w * tiles_h, width,
                              height, D if packed else None)
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
        grads = torch.cat([torch.stack(rows), v_col])  # [6+D, nt, L]
        v_slot[:, cb.idx[cb.valid]] = grads[:, cb.valid]
        n_live += int(cb.live.sum())
    return (pack_rows(v_slot) if pack_grads else v_slot), n_live


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
    packed: bool = False,
    pack_grads: bool = False,
    n_channels: Optional[int] = None,  # D, with `packed`
) -> torch.Tensor:
    """Per-slot gradients of (x, y, a, b, c, opacity, colors) at the sorted
    positions, [6+D, P] f32; slots outside every span are zero.  The same
    inputs give the same bits from run to run.  On the card, `live_counts`
    receives each tile's count of live (pixel, slot) pairs.  With `packed`
    the fields are the packed payload the packed forward read; with
    `pack_grads` the result is grad_pack_rows(D) bf16-pair carriers of the
    6+D rows, zero bits outside every span.  More than MAX_CHANNELS
    channels run in `channel_groups` (v_t in the first only, `live_counts`
    from the first), with float32 rows, the geometry rows added over the
    groups in group order: the result is then the 6+D float32 rows even
    with `pack_grads`."""
    D, n_tiles = _check_composite_args("rasterize_bwd", fields, bounds, n_images, tile,
                                       tiles_w, tiles_h, packed, n_channels)
    for name, t, shape in (("v_pix", v_pix, (n_images, height, width, D)),
                           ("v_t", v_t, (n_images, height, width)),
                           ("pix_out", pix_out, (n_images, height, width, D)),
                           ("t_final", t_final, (n_images, height, width))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if D > MAX_CHANNELS:
        parts = []
        for c0, c1 in channel_groups(D):
            parts.append(rasterize_bwd(
                _group_fields(fields, c0, c1, packed), bounds, n_images, tile, tiles_w, tiles_h,
                width, height, v_pix[..., c0:c1].contiguous(),
                v_t if c0 == 0 else torch.zeros_like(v_t), pix_out[..., c0:c1].contiguous(),
                t_final, live_counts if c0 == 0 else None, packed, False, c1 - c0))
        return torch.cat([_add_groups(parts, 6)] + [p[6:] for p in parts])
    if not check_kernel_device("rasterize_bwd", fields, bounds, v_pix, v_t, pix_out, t_final):
        if live_counts is not None:
            raise ValueError("live_counts is filled by the CUDA kernel only")
        return rasterize_bwd_plain(fields, bounds, n_images, tile, tiles_w, tiles_h, width,
                                   height, v_pix, v_t, pix_out, t_final, packed, pack_grads,
                                   D)[0]
    lib = _build.load("rasterize_bwd")
    rows = grad_pack_rows(D) if pack_grads else 6 + D
    # the kernel writes every element, zeros where no live pair reaches,
    # when there is a tile to write them
    alloc = torch.empty if n_tiles > 0 else torch.zeros
    v_slot = alloc((rows, fields.shape[1]), dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize_bwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tile,
        tiles_w, tiles_w * tiles_h, width, height, n_tiles, int(packed), int(pack_grads),
        v_pix.data_ptr(), v_t.data_ptr(), pix_out.data_ptr(), t_final.data_ptr(),
        v_slot.data_ptr(), _counts_ptr(live_counts, n_tiles, fields.device),
        _build.stream_of(v_slot),
    )
    _build.check(lib, code, "rasterize_bwd")
    if packed or pack_grads:
        rasterize_bwd.launches_packed += 1
    else:
        rasterize_bwd.launches += 1
    return v_slot


rasterize_bwd.launches = 0
rasterize_bwd.launches_packed = 0
