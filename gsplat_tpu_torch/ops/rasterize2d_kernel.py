"""2DGS surfel composite, forward (K6a) and backward (K6b): wrappers for
`csrc/rasterize2d_fwd.cu` and `csrc/rasterize2d_bwd.cu`.

K6a `rasterize2d_fwd` replaces gsplat_tpu/ops/rasterize2d_pallas.py:_fwd_kernel
(:92, wrapper _fwd_call_2dgs :476); K6b `rasterize2d_bwd` replaces _bwd_kernel
(:213, wrapper _bwd_call_2dgs :521).  On a CUDA tensor a wrapper launches its
kernel (or raises); the plain versions run only for CPU tensors.  Launches
are counted in `<wrapper>.launches`.

Slot field rows (input [15+D, P], sorted by (tile, depth)): 0 x, 1 y, 2-4 u,
5-7 v, 8-10 w (the ray transform's rows), 11 opacity, 12..11+D colours (depth
last), 12+D..14+D normals.  Per pixel the forward writes [I, H, W, D+5]:
D colours, 3 normals, distortion, median depth; T_final [I, H, W]; and the
median slot [I, H, W] as an int32 sorted position (-1: none).  The backward
gives per-slot gradients of the 15 + D field rows at the sorted positions.

Semantics follow the JAX oracle (gsplat_tpu/ops/rasterize2d_ref.py): a pixel
stops for good at the first surfel that would take its transmittance to
<= 1e-4, and that surfel is excluded; the distortion's A_i is the oracle's
exclusive sum of the weights (cumsum(w) - w).  The JAX Pallas kernels can
resume a stopped pixel in a later 128-slot chunk and carry the median slot
in float32; neither is copied.  The plain forward repeats the kernel's
arithmetic operation by operation, its sums serial in slot order, so that the
two agree bit for bit; the two backwards differ by the order of the sums
over a tile's pixels, and K6b forms the ray transform's rows from three
per-slot sums of the 3D response's gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD
from .rasterize_kernel import MAX_CHANNELS, _add_groups, _counts_ptr, channel_groups, tile_sets

TILE_2D = 16  # the 2DGS composite's only tile size
PLAIN_BUDGET = 1 << 22  # (tile, pixel, slot) elements per batch of the plain versions
N_FIXED_ROWS = 15  # x, y, u, v, w, opacity and normals around the D colours
ROW_OP, ROW_COLOR = 11, 12


class _SurfelBatch(NamedTuple):
    """The surfel response and the front-to-back replay of a batch of tiles
    over their padded spans of L slots: what both plain versions use."""

    idx: torch.Tensor  # [nt, L] slot of each padded position (clamped)
    valid: torch.Tensor  # [nt, L] position lies inside the tile's span
    slot: torch.Tensor  # [nt, 1, L] sorted position of each padded position
    g: torch.Tensor  # [F, nt, L] the slots' fields
    hu: Tuple[torch.Tensor, ...]  # h_u, h_v: 3 x [nt, n_pix, L]
    hv: Tuple[torch.Tensor, ...]
    cx: torch.Tensor
    cy: torch.Tensor
    cz_safe: torch.Tensor  # c_z, 1 where it is 0 (gated)
    sigma3: torch.Tensor
    dx: torch.Tensor  # mean minus pixel centre
    dy: torch.Tensor
    use2d: torch.Tensor  # the 2D filter is the smaller response
    vis: torch.Tensor  # exp(-sigma)
    unclamped: torch.Tensor  # op * vis < 0.99
    alpha: torch.Tensor  # gated alpha (0 where gated)
    t_before: torch.Tensor  # transmittance before each slot
    live: torch.Tensor  # the pair contributes
    weights: torch.Tensor  # alpha * t_before on live pairs, else 0
    t_final: torch.Tensor  # [nt, n_pix]
    evaluated: torch.Tensor  # [nt, n_pix] slots each pixel reads before it stops
    px: torch.Tensor  # [nt, n_pix, 1] pixel centre
    py: torch.Tensor
    at: Tuple[torch.Tensor, ...]  # (image, row, column) [nt, n_pix], clamped to the image
    inside: torch.Tensor  # [nt, n_pix] pixel lies in the image


def _surfel_batch(fields, starts, counts, tiles, L, tiles_w, tiles_per_image, width,
                  height) -> _SurfelBatch:
    """The response of every (pixel, padded slot) of the tiles `tiles`, each
    operation rounded alone in the kernel's order (csrc/surfel.cuh), then
    the serial replay of T and the stop."""
    dev = fields.device
    n_pix = TILE_2D * TILE_2D
    j = torch.arange(L, device=dev)
    valid = j[None] < counts[tiles, None]  # [nt, L]
    slot = starts[tiles, None] + j[None]
    idx = torch.clamp(slot, max=max(fields.shape[1] - 1, 0))
    g = fields[:, idx]  # [F, nt, L]

    def row(i):
        return g[i][:, None, :]  # [nt, 1, L]

    im = tiles // tiles_per_image
    tl = tiles % tiles_per_image
    p = torch.arange(n_pix, device=dev)
    x = (tl % tiles_w)[:, None] * TILE_2D + (p % TILE_2D)[None]
    y = (tl // tiles_w)[:, None] * TILE_2D + (p // TILE_2D)[None]
    inside = (x < width) & (y < height)  # [nt, n_pix]
    px = (x.to(torch.float32) + 0.5)[..., None]
    py = (y.to(torch.float32) + 0.5)[..., None]

    hu = tuple(px * row(8 + k) - row(2 + k) for k in range(3))
    hv = tuple(py * row(8 + k) - row(5 + k) for k in range(3))
    cx = hu[1] * hv[2] - hu[2] * hv[1]
    cy = hu[2] * hv[0] - hu[0] * hv[2]
    cz = hu[0] * hv[1] - hu[1] * hv[0]
    cz_safe = torch.where(cz == 0.0, 1.0, cz)
    su = cx / cz_safe
    sv = cy / cz_safe
    sigma3 = su * su + sv * sv
    dx = row(0) - px
    dy = row(1) - py
    sigma2 = 2.0 * (dx * dx + dy * dy)
    use2d = sigma2 < sigma3
    sigma = 0.5 * torch.where(use2d, sigma2, sigma3)
    vis = torch.exp(-sigma)
    raw = row(ROW_OP) * vis
    alpha = torch.clamp(raw, max=MAX_ALPHA)
    gate = (cz != 0.0) & (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & valid[:, None, :]
    alpha = torch.where(gate, alpha, 0.0)

    # the serial replay: T *= 1 - alpha on live pairs, front to back
    T = inside.to(torch.float32)  # T starts at 0 outside the image
    done = ~inside
    t_before = torch.empty_like(alpha)
    live = torch.zeros_like(gate)
    evaluated = torch.zeros(T.shape, dtype=torch.int64, device=dev)
    for jj in range(L):
        evaluated += valid[:, jj, None] & ~done
        nxt = T * (1.0 - alpha[..., jj])
        kept = gate[..., jj] & ~done
        stop = kept & (nxt <= TRANSMITTANCE_THRESHOLD)
        lv = kept & ~stop
        t_before[..., jj] = T
        live[..., jj] = lv
        T = torch.where(lv, nxt, T)
        done = done | stop
    at = (im[:, None].expand_as(x), y.clamp(max=height - 1), x.clamp(max=width - 1))
    return _SurfelBatch(
        idx=idx, valid=valid, slot=slot[:, None, :], g=g, hu=hu, hv=hv, cx=cx, cy=cy,
        cz_safe=cz_safe, sigma3=sigma3, dx=dx, dy=dy, use2d=use2d, vis=vis,
        unclamped=raw < MAX_ALPHA, alpha=alpha, t_before=t_before, live=live,
        weights=torch.where(live, alpha * t_before, 0.0), t_final=torch.where(inside, T, 0.0),
        evaluated=evaluated, px=px, py=py, at=at, inside=inside,
    )


# csrc/surfel.cuh's early reject, in float32: what the kernels gate before
# the exact path.  Neither plain version uses it (they take the exact path
# for every pair, which decides the same); the tests hold it to them.
GATE_MARGIN = 2.0 ** -6  # delta
GATE_SLACK = 1.0 + 2.0 ** -10
GATE_FLOOR = 2.0 ** -100
OP_DEAD = float(torch.tensor(ALPHA_THRESHOLD, dtype=torch.float32) * (1.0 - 2.0 ** -16))
BLOCK_ENVELOPE = 2.0 ** -19


def surfel_gate_plain(rows: torch.Tensor) -> torch.Tensor:
    """Each slot's gate term g (csrc/surfel.cuh:surfel_gate) from its first
    12 rows [12+, *S] (x, y, u, v, w, opacity): +inf if a row is not finite,
    -inf if the opacity is below OP_DEAD, else 2 (ln(255 op) + delta)(1 + s)."""
    rows = rows[:ROW_COLOR]
    op = rows[ROW_OP]
    g = (2.0 * (torch.log(op * 255.0) + GATE_MARGIN)) * GATE_SLACK
    g = torch.where(op < OP_DEAD, -torch.inf, g)
    return torch.where(torch.isfinite(rows).all(0), g, torch.inf)


def surfel_certainly_gated_plain(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                                 gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """csrc/surfel.cuh's early reject: True for each (pixel, slot) pair whose
    8x4 block of its 16x16 tile the slot's block mask gates (every pixel of
    the block).  `rows` [12+, *S] holds each slot's rows as surfel_gate_plain
    reads them, `px`, `py` the pixel centres, broadcasting against S; `gate`
    is surfel_gate_plain(rows) if not given.  The fused multiply-adds of the
    block centre's c are rounded once, through float64."""
    g = surfel_gate_plain(rows) if gate is None else gate
    x, y = torch.floor(px), torch.floor(py)
    P = torch.floor(x / TILE_2D) * TILE_2D + 15.5
    Q = torch.floor(y / TILE_2D) * TILE_2D + 15.5
    bx = torch.floor(x / 8.0) * 8.0 + 4.0
    by = torch.floor(y / 4.0) * 4.0 + 2.0
    u, v, w = rows[2:5], rows[5:8], rows[8:11]
    c, reach = [], []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        A = v[i1] * w[i2] - v[i2] * w[i1]
        B = w[i1] * u[i2] - w[i2] * u[i1]
        C = u[i1] * v[i2] - u[i2] * v[i1]
        a = (v[i1] * w[i2]).abs() + (v[i2] * w[i1]).abs()
        b = (w[i1] * u[i2]).abs() + (w[i2] * u[i1]).abs()
        k = (u[i1] * v[i2]).abs() + (u[i2] * v[i1]).abs()
        S = ((P * w[i1].abs() + u[i1].abs()) * (Q * w[i2].abs() + v[i2].abs())
             + (P * w[i2].abs() + u[i2].abs()) * (Q * w[i1].abs() + v[i1].abs()))
        e = BLOCK_ENVELOPE * (P * a + Q * b + k + S)
        reach.append((3.5 * a + 1.5 * b) + e)
        inner = (by.double() * B.double() + C.double()).float()
        c.append((bx.double() * A.double() + inner.double()).float())
    lx = torch.clamp(c[0].abs() - reach[0], min=0.0)
    ly = torch.clamp(c[1].abs() - reach[1], min=0.0)
    hz = c[2].abs() + reach[2]
    lhs = lx * lx + ly * ly
    q = g * (hz * hz)
    dX = torch.clamp((rows[0] - bx).abs() - 3.5, min=0.0)
    dY = torch.clamp((rows[1] - by).abs() - 1.5, min=0.0)
    s2 = 2.0 * (dX * dX + dY * dY)
    return (g == -torch.inf) | ((s2 > g * GATE_SLACK) & (q >= GATE_FLOOR) & (lhs > q))


def _batches(bounds, n_tiles, tiles, budget):
    """(starts, counts, tile ids, longest span) per batch of the tiles
    `tiles` (all when None) whose padded work fits `budget` elements."""
    starts = bounds[:-1].long()
    counts = (bounds[1:] - bounds[:-1]).long()
    for ids, L in tile_sets(bounds, n_tiles, TILE_2D * TILE_2D, tiles, budget):
        yield starts, counts, ids, L


def rasterize2d_fwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, n_images: int, tiles_w: int, tiles_h: int,
    width: int, height: int, tiles: Optional[torch.Tensor] = None,
    budget: int = PLAIN_BUDGET,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6a, operation by operation as the kernel, its sums
    serial in slot order.  With `tiles` (tile ids), only their pixels are
    composited; the others keep zeros, T 0 and median slot -1.  `budget`
    bounds the (tile, pixel, slot) elements of one batch."""
    D = fields.shape[0] - N_FIXED_ROWS
    C = D + 3
    dev = fields.device
    out = torch.zeros((n_images, height, width, D + 5), dtype=torch.float32, device=dev)
    out_t = torch.zeros((n_images, height, width), dtype=torch.float32, device=dev)
    med_slot = torch.full((n_images, height, width), -1, dtype=torch.int32, device=dev)
    for starts, counts, ids, L in _batches(bounds, n_images * tiles_w * tiles_h, tiles, budget):
        sb = _surfel_batch(fields, starts, counts, ids, L, tiles_w, tiles_w * tiles_h,
                           width, height)
        ch = sb.g[ROW_COLOR : ROW_COLOR + C].permute(1, 2, 0)  # [nt, L, C]
        m = sb.g[ROW_COLOR + D - 1]  # [nt, L] the depth channel
        nt = ids.shape[0]
        acc = torch.zeros((nt, TILE_2D * TILE_2D, C), dtype=torch.float32, device=dev)
        dist = torch.zeros(acc.shape[:2], dtype=torch.float32, device=dev)
        A = torch.zeros_like(dist)
        B = torch.zeros_like(dist)
        for jj in range(L):
            wj = sb.weights[..., jj]
            mj = m[:, jj, None]
            acc = acc + wj[..., None] * ch[:, None, jj]
            dist = dist + (2.0 * wj) * (mj * A - B)
            A = A + wj
            B = B + wj * mj
        # the median: the last live slot whose entry T is above 0.5
        j = torch.arange(L, device=dev)
        last = torch.where(sb.live & (sb.t_before > 0.5), j, -1).amax(dim=-1)  # [nt, n_pix]
        has = last >= 0
        med = torch.where(has, torch.gather(m, 1, last.clamp(min=0)), 0.0)
        slot = torch.where(has, starts[ids, None] + last, -1).to(torch.int32)
        inside = sb.inside
        at = tuple(a[inside] for a in sb.at)
        out[at] = torch.cat([acc, dist[..., None], med[..., None]], dim=-1)[inside]
        out_t[at] = sb.t_final[inside]
        med_slot[at] = slot[inside]
    return out, out_t, med_slot


def _check_args(name, fields, bounds, n_images, tiles_w, tiles_h):
    """Validate what K6a and K6b share; returns (D, n_tiles)."""
    if fields.dim() != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous float32 [15+D, P] tensor")
    D = fields.shape[0] - N_FIXED_ROWS
    if D < 1:
        raise ValueError(f"{name} takes at least one colour channel, got D={D}")
    n_tiles = n_images * tiles_w * tiles_h
    if bounds.shape != (n_tiles + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [{n_tiles + 1}], got {bounds.dtype} "
                         f"{tuple(bounds.shape)}")
    return D, n_tiles


def _group_fields(fields: torch.Tensor, D: int, c0: int, c1: int) -> torch.Tensor:
    """The slot rows of colour channels [c0, c1) with the 12 geometry rows
    before them and the 3 normal rows after them."""
    return torch.cat([fields[:ROW_COLOR], fields[ROW_COLOR + c0 : ROW_COLOR + c1],
                      fields[ROW_COLOR + D :]])


def rasterize2d_fwd(
    fields: torch.Tensor,  # [15+D, P] f32 sorted slot rows
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans in the sorted stream
    n_images: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
    pair_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
    eval_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
    exact_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
    unsound_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every 16x16 tile of surfels front to back.

    Returns (out [I, H, W, D+5] f32: colours, normals, distortion, median
    depth; T_final [I, H, W] f32; median slot [I, H, W] i32).  On the card,
    `pair_counts` receives each tile's contributing (pixel, slot) pairs,
    which the backward's live pairs must equal, `eval_counts` the pairs it
    evaluated, `exact_counts` those of them that took the exact path (the
    early reject's block masks gated the rest), and `unsound_counts` the
    masked pairs that the exact path, run on them too, would not have gated
    (0 unless the reject's margin is wrong).  Any counter makes the kernel
    count.

    More than MAX_CHANNELS colour channels (the depth channel, last,
    counted) composite in `channel_groups` of the colours, each with the
    geometry and normal rows; the depth channel rides in the last group,
    which gives the normals, distortion and median depth.  T, the median
    slot and the counters come from the first group.
    """
    D, n_tiles = _check_args("rasterize2d_fwd", fields, bounds, n_images, tiles_w, tiles_h)
    counters = (pair_counts, eval_counts, exact_counts, unsound_counts)
    if D > MAX_CHANNELS:
        outs = [rasterize2d_fwd(_group_fields(fields, D, c0, c1), bounds, n_images, tiles_w,
                                tiles_h, width, height,
                                *(counters if c0 == 0 else (None,) * len(counters)))
                for c0, c1 in channel_groups(D)]
        out = torch.cat([o[0][..., : o[0].shape[-1] - 5] for o in outs] + [outs[-1][0][..., -5:]],
                        dim=-1)
        return out, outs[0][1], outs[0][2]
    if not check_kernel_device("rasterize2d_fwd", fields, bounds):
        if any(c is not None for c in counters):
            raise ValueError("pair_counts, eval_counts, exact_counts and unsound_counts are "
                             "filled by the CUDA kernel only")
        return rasterize2d_fwd_plain(fields, bounds, n_images, tiles_w, tiles_h, width, height)
    lib = _build.load("rasterize2d_fwd")
    dev = fields.device
    out = torch.empty((n_images, height, width, D + 5), dtype=torch.float32, device=dev)
    out_t = torch.empty((n_images, height, width), dtype=torch.float32, device=dev)
    med_slot = torch.empty((n_images, height, width), dtype=torch.int32, device=dev)
    if any(c is not None for c in counters):
        counters = tuple(torch.empty(n_tiles, dtype=torch.int32, device=dev) if c is None else c
                         for c in counters)
    code = lib.gs_rasterize2d_fwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tiles_w,
        tiles_w * tiles_h, width, height, n_tiles, out.data_ptr(), out_t.data_ptr(),
        med_slot.data_ptr(), *(_counts_ptr(c, n_tiles, dev) for c in counters),
        _build.stream_of(out),
    )
    _build.check(lib, code, "rasterize2d_fwd")
    rasterize2d_fwd.launches += 1
    return out, out_t, med_slot


rasterize2d_fwd.launches = 0


# ---------------------------------------------------------------------------
# K6b: per-slot gradients at the sorted positions
# ---------------------------------------------------------------------------


def rasterize2d_bwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, n_images: int, tiles_w: int, tiles_h: int,
    width: int, height: int, v_pix: torch.Tensor, v_t: torch.Tensor, pix_out: torch.Tensor,
    t_final: torch.Tensor, med_slot: torch.Tensor, tiles: Optional[torch.Tensor] = None,
    budget: int = PLAIN_BUDGET,
) -> Tuple[torch.Tensor, int]:
    """Plain version of K6b: the forward's replay (`_surfel_batch`), then the
    per-pair gradient terms summed over each tile's pixels.  Returns (v_slot
    [15+D, P], live (pixel, slot) pairs); with `tiles`, of those tiles' slots
    only."""
    F, P = fields.shape
    D = F - N_FIXED_ROWS
    C = D + 3
    v_slot = torch.zeros((F, P), dtype=torch.float32, device=fields.device)
    n_live = 0
    for starts, counts, ids, L in _batches(bounds, n_images * tiles_w * tiles_h, tiles, budget):
        sb = _surfel_batch(fields, starts, counts, ids, L, tiles_w, tiles_w * tiles_h,
                           width, height)
        vp, po = v_pix[sb.at], pix_out[sb.at]  # [nt, n_pix, D+5]
        vch = vp[..., :C]
        v_dist = vp[..., C, None]
        v_med = vp[..., C + 1, None]
        tf = t_final[sb.at][..., None]
        dtot = (vch * po[..., :C]).sum(-1, keepdim=True)
        vt_term = v_t[sb.at][..., None] * tf
        sw_tot, sm_tot = 1.0 - tf, po[..., D - 1, None]
        gww_tot = 2.0 * v_dist * po[..., C, None]
        ch = sb.g[ROW_COLOR : ROW_COLOR + C]  # [C, nt, L]
        m = sb.g[ROW_COLOR + D - 1][:, None, :]  # [nt, 1, L]
        w, alpha, tb = sb.weights, sb.alpha, sb.t_before

        d = torch.einsum("tpc,ctl->tpl", vch, ch)
        e_incl = torch.cumsum(w * d, dim=-1)
        ra = 1.0 / (1.0 - alpha)  # alpha <= 0.99
        v_alpha = d * tb - (dtot - e_incl) * ra - vt_term * ra
        aw_incl = torch.cumsum(w, dim=-1)
        bw_incl = torch.cumsum(w * m, dim=-1)
        A, B = aw_incl - w, bw_incl - w * m
        sw_suf, sm_suf = sw_tot - aw_incl, sm_tot - bw_incl
        gw = 2.0 * v_dist * ((m * A - B) + sm_suf - m * sw_suf)
        gww_incl = torch.cumsum(gw * w, dim=-1)
        v_alpha = v_alpha + gw * tb - (gww_tot - gww_incl) * ra
        v_alpha = torch.where(sb.live, v_alpha, 0.0)
        v_m = 2.0 * v_dist * w * (A - sw_suf)
        v_m = v_m + torch.where(sb.live & (sb.slot == med_slot[sb.at][..., None]), v_med, 0.0)

        grad_ok = sb.live & sb.unclamped
        v_sigma = torch.where(grad_ok, -alpha * v_alpha, 0.0)
        v_op = torch.where(grad_ok, sb.vis * v_alpha, 0.0)
        v_s2 = torch.where(sb.use2d, v_sigma, 0.0)
        v_s3 = torch.where(sb.use2d, 0.0, v_sigma)
        inv_cz2 = 1.0 / (sb.cz_safe * sb.cz_safe)
        v_cx = v_s3 * sb.cx * inv_cz2
        v_cy = v_s3 * sb.cy * inv_cz2
        v_cz = -v_s3 * sb.sigma3 / sb.cz_safe
        hu, hv = sb.hu, sb.hv
        v_hu = (hv[1] * v_cz - hv[2] * v_cy, hv[2] * v_cx - hv[0] * v_cz,
                hv[0] * v_cy - hv[1] * v_cx)
        v_hv = (v_cy * hu[2] - v_cz * hu[1], v_cz * hu[0] - v_cx * hu[2],
                v_cx * hu[1] - v_cy * hu[0])
        rows = ([2.0 * v_s2 * sb.dx, 2.0 * v_s2 * sb.dy]
                + [-v for v in v_hu] + [-v for v in v_hv]
                + [sb.px * v_hu[k] + sb.py * v_hv[k] for k in range(3)] + [v_op])
        geo = torch.stack([r.sum(1) for r in rows])  # [12, nt, L]
        v_ch = torch.einsum("tpc,tpl->ctl", vch, w)
        v_ch[D - 1] += v_m.sum(1)
        grads = torch.cat([geo, v_ch])  # [F, nt, L]
        v_slot[:, sb.idx[sb.valid]] = grads[:, sb.valid]
        n_live += int(sb.live.sum())
    return v_slot, n_live


def rasterize2d_bwd(
    fields: torch.Tensor,  # [15+D, P] f32 sorted slot rows, as the forward read them
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans
    n_images: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
    v_pix: torch.Tensor,  # [I, H, W, D+5] cotangent of the forward's out
    v_t: torch.Tensor,  # [I, H, W] cotangent of T_final
    pix_out: torch.Tensor,  # [I, H, W, D+5] the forward's out
    t_final: torch.Tensor,  # [I, H, W] the forward's T_final
    med_slot: torch.Tensor,  # [I, H, W] i32 the forward's median slot
    live_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
) -> torch.Tensor:
    """Per-slot gradients of the 15+D field rows at the sorted positions,
    [15+D, P] f32; slots outside every span are zero.  The same inputs give
    the same bits from run to run.  On the card, `live_counts` receives each
    tile's count of live (pixel, slot) pairs.  More than MAX_CHANNELS colour
    channels run in the forward's `channel_groups`: each group takes its
    colours' cotangents, the last also those of the normals, distortion and
    median, the first v_t (`live_counts` from the first); the geometry rows'
    gradients add over the groups in float32, in group order."""
    D, n_tiles = _check_args("rasterize2d_bwd", fields, bounds, n_images, tiles_w, tiles_h)
    img = (n_images, height, width)
    for name, t, shape, dtype in (("v_pix", v_pix, img + (D + 5,), torch.float32),
                                  ("v_t", v_t, img, torch.float32),
                                  ("pix_out", pix_out, img + (D + 5,), torch.float32),
                                  ("t_final", t_final, img, torch.float32),
                                  ("med_slot", med_slot, img, torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if D > MAX_CHANNELS:
        groups = channel_groups(D)
        tail_v, tail_out = v_pix[..., D:], pix_out[..., D:]  # normals, distortion, median
        parts = []
        for c0, c1 in groups:
            last = c1 == D
            v_g = torch.cat([v_pix[..., c0:c1], tail_v if last else torch.zeros_like(tail_v)],
                            dim=-1)
            parts.append(rasterize2d_bwd(
                _group_fields(fields, D, c0, c1), bounds, n_images, tiles_w, tiles_h, width,
                height, v_g, v_t if c0 == 0 else torch.zeros_like(v_t),
                torch.cat([pix_out[..., c0:c1], tail_out], dim=-1), t_final, med_slot,
                live_counts if c0 == 0 else None))
        # the normal rows from the last group, which alone took their cotangents
        return torch.cat([_add_groups(parts, ROW_COLOR)] + [p[ROW_COLOR:-3] for p in parts]
                         + [parts[-1][-3:]])
    if not check_kernel_device("rasterize2d_bwd", fields, bounds, v_pix, v_t, pix_out, t_final,
                               med_slot):
        if live_counts is not None:
            raise ValueError("live_counts is filled by the CUDA kernel only")
        return rasterize2d_bwd_plain(fields, bounds, n_images, tiles_w, tiles_h, width, height,
                                     v_pix, v_t, pix_out, t_final, med_slot)[0]
    lib = _build.load("rasterize2d_bwd")
    # the kernel writes every element, zeros where no live pair reaches
    v_slot = torch.empty(fields.shape, dtype=torch.float32, device=fields.device)
    code = lib.gs_rasterize2d_bwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), D, tiles_w,
        tiles_w * tiles_h, width, height, n_tiles, v_pix.data_ptr(), v_t.data_ptr(),
        pix_out.data_ptr(), t_final.data_ptr(), med_slot.data_ptr(), v_slot.data_ptr(),
        _counts_ptr(live_counts, n_tiles, fields.device), _build.stream_of(v_slot),
    )
    _build.check(lib, code, "rasterize2d_bwd")
    rasterize2d_bwd.launches += 1
    return v_slot


rasterize2d_bwd.launches = 0
