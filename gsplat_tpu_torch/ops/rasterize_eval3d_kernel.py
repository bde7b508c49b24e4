"""eval3d composite, forward (K7a) and backward (K7b): wrappers for
`csrc/rasterize_eval3d_fwd.cu` and `csrc/rasterize_eval3d_bwd.cu`.

K7a `rasterize_eval3d_fwd` replaces
gsplat_tpu/ops/rasterize_eval3d_pallas.py:_fwd_kernel (:122, wrapper
_fwd_call_eval3d :526); K7b `rasterize_eval3d_bwd` replaces _bwd_kernel
(:232, wrapper _bwd_call_eval3d :570).  On a CUDA tensor a wrapper launches
its kernel (or raises); the plain versions run only for CPU tensors.
Launches are counted in `<wrapper>.launches`.

Slot field rows (input [F, P], sorted by (tile, depth);
rasterize_eval3d_pallas.py:_field_layout :53): 0-2 x, 3-11 M = diag(1/s) R^T
row-major, 12 opacity, [13-15 scale with the hit distance], D colour rows
(the last one replaced by the hit distance with it), [3 normal rows].  Rays
are read in image layout, [I, H, W, 6] (origin, direction).  Per pixel the
forward writes [I, H, W, D + 3*normals] and T_final [I, H, W]; the backward
gives per-slot gradients of the F rows at the sorted positions and per-pixel
ray gradients [I, H, W, 6].

Semantics follow the JAX oracle (gsplat_tpu/ops/rasterize_eval3d_ref.py): a
pixel stops for good at the first gaussian that would take its
transmittance to <= 1e-4, which is excluded (the Pallas kernels can resume
it in a later 128-slot chunk; not copied).  A ray whose direction has
|d|^2 <= 1e-12 starts at T = 0, as the JAX kernels do: it renders nothing
and its T_final is 0.  The plain forward repeats the kernel's arithmetic
operation by operation (csrc/ray3d.cuh), its sums serial in slot order, so
that the two agree bit for bit.  The plain backward repeats the kernel's
per-pair terms operation by operation and sums each pixel's ray gradients
serially in slot order, as the kernel does; the two differ only by the
order of the per-slot sums over a tile's pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .projection import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_THRESHOLD
from .rasterize2d_kernel import PLAIN_BUDGET, _batches
from .rasterize_kernel import MAX_CHANNELS, _add_groups, _counts_ptr, channel_groups

TILE_3D = 16  # the eval3d composite's only tile size
ROW_X, ROW_M, ROW_OP, ROW_SCALE = 0, 3, 12, 13


def field_layout(n_channels: int, use_hit_distance: bool, return_normals: bool):
    """(F, first colour row, first normal row or None, first scale row or None)."""
    scale0 = ROW_SCALE if use_hit_distance else None
    color0 = ROW_SCALE + (3 if use_hit_distance else 0)
    normal0 = color0 + n_channels if return_normals else None
    return color0 + n_channels + (3 if return_normals else 0), color0, normal0, scale0


def _dot3(a, b):
    """a0*b0 + a1*b1 + a2*b2, each operation rounded alone, left to right."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


class _RayBatch(NamedTuple):
    """The ray response and the front-to-back replay of a batch of tiles over
    their padded spans of L slots: what both plain versions use."""

    idx: torch.Tensor  # [nt, L] slot of each padded position (clamped)
    valid: torch.Tensor  # [nt, L] position lies inside the tile's span
    g: torch.Tensor  # [F, nt, L] the slots' fields
    o: Tuple[torch.Tensor, ...]  # ray origin, 3 x [nt, n_pix, 1]
    d: Tuple[torch.Tensor, ...]  # ray direction
    gv: Tuple[torch.Tensor, ...]  # M o - M x, 3 x [nt, n_pix, L]
    uh: Tuple[torch.Tensor, ...]  # u normalized
    c: Tuple[torch.Tensor, ...]  # uh x gv
    inv_un: torch.Tensor
    hit_t: torch.Tensor
    vis: torch.Tensor  # exp(-0.5 |c|^2)
    unclamped: torch.Tensor  # op * vis < 0.99
    alpha: torch.Tensor  # gated alpha (0 where gated)
    q: Optional[torch.Tensor]  # |s * uh| (hit distance only)
    hd: Optional[torch.Tensor]  # the hit distance
    t_before: torch.Tensor  # transmittance before each slot
    live: torch.Tensor  # the pair contributes
    weights: torch.Tensor  # alpha * t_before on live pairs, else 0
    t_final: torch.Tensor  # [nt, n_pix]
    at: Tuple[torch.Tensor, ...]  # (image, row, column) [nt, n_pix], clamped to the image
    inside: torch.Tensor  # [nt, n_pix] pixel lies in the image


def _ray_batch(fields, starts, counts, tiles, L, rays, tiles_w, tiles_per_image, width, height,
               hit) -> _RayBatch:
    """The response of every (pixel, padded slot) of the tiles `tiles`, each
    operation rounded alone in the kernel's order (csrc/ray3d.cuh), then the
    serial replay of T and the stop."""
    dev = fields.device
    n_pix = TILE_3D * TILE_3D
    j = torch.arange(L, device=dev)
    valid = j[None] < counts[tiles, None]  # [nt, L]
    idx = torch.clamp(starts[tiles, None] + j[None], max=max(fields.shape[1] - 1, 0))
    g = fields[:, idx]  # [F, nt, L]

    def row(i):
        return g[i][:, None, :]  # [nt, 1, L]

    im = tiles // tiles_per_image
    tl = tiles % tiles_per_image
    p = torch.arange(n_pix, device=dev)
    x = (tl % tiles_w)[:, None] * TILE_3D + (p % TILE_3D)[None]
    y = (tl // tiles_w)[:, None] * TILE_3D + (p // TILE_3D)[None]
    inside = (x < width) & (y < height)  # [nt, n_pix]
    at = (im[:, None].expand_as(x), y.clamp(max=height - 1), x.clamp(max=width - 1))
    ray = torch.where(inside[..., None], rays[at], 0.0)  # [nt, n_pix, 6]
    o = tuple(ray[..., k, None] for k in range(3))
    d = tuple(ray[..., 3 + k, None] for k in range(3))

    X = tuple(row(ROW_X + k) for k in range(3))
    u, gv = [], []
    for k in range(3):
        m = tuple(row(ROW_M + 3 * k + i) for i in range(3))
        u.append(_dot3(m, d))
        gv.append(_dot3(m, o) - _dot3(m, X))
    inv_un = 1.0 / torch.sqrt(torch.clamp(_dot3(u, u), min=1e-24))
    uh = tuple(uk * inv_un for uk in u)
    c = _cross(uh, gv)
    gray = _dot3(c, c)
    hit_t = -_dot3(uh, gv)
    vis = torch.exp(-0.5 * gray)
    raw = row(ROW_OP) * vis
    alpha = torch.clamp(raw, max=MAX_ALPHA)
    gate = (hit_t >= 0.0) & (alpha >= ALPHA_THRESHOLD) & valid[:, None, :]
    alpha = torch.where(gate, alpha, 0.0)
    q = hd = None
    if hit:
        b = tuple(row(ROW_SCALE + k) * uh[k] for k in range(3))
        q = torch.sqrt(torch.clamp(_dot3(b, b), min=1e-24))
        hd = hit_t * q

    # the serial replay: T *= 1 - alpha on live pairs, front to back; a
    # pixel outside the image or with a zero ray direction starts at T = 0
    start = inside & (_dot3(d, d)[..., 0] > 1e-12)
    T = start.to(torch.float32)
    done = ~start
    t_before = torch.empty_like(alpha)
    live = torch.zeros_like(gate)
    for jj in range(L):
        nxt = T * (1.0 - alpha[..., jj])
        kept = gate[..., jj] & ~done
        stop = kept & (nxt <= TRANSMITTANCE_THRESHOLD)
        lv = kept & ~stop
        t_before[..., jj] = T
        live[..., jj] = lv
        T = torch.where(lv, nxt, T)
        done = done | stop
    return _RayBatch(
        idx=idx, valid=valid, g=g, o=o, d=d, gv=tuple(gv), uh=uh, c=c,
        inv_un=inv_un, hit_t=hit_t, vis=vis, unclamped=raw < MAX_ALPHA, alpha=alpha, q=q, hd=hd,
        t_before=t_before, live=live, weights=torch.where(live, alpha * t_before, 0.0),
        t_final=T, at=at, inside=inside,
    )


def _normal_sign(rb: _RayBatch, normal0: int) -> torch.Tensor:
    """-1 where the slot's normal faces along the ray (n . d > 0), else 1."""
    n = tuple(rb.g[normal0 + k][:, None, :] for k in range(3))
    return torch.where(_dot3(n, rb.d) > 0.0, -1.0, 1.0)


def rasterize_eval3d_fwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor, n_images: int, tiles_w: int,
    tiles_h: int, width: int, height: int, use_hit_distance: bool, return_normals: bool,
    tiles: Optional[torch.Tensor] = None, budget: int = PLAIN_BUDGET,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7a, operation by operation as the kernel, its sums
    serial in slot order.  With `tiles` (tile ids), only their pixels are
    composited; the others keep zeros.  `budget` bounds the (tile, pixel,
    slot) elements of one batch."""
    F = fields.shape[0]
    D = F - ROW_SCALE - 3 * use_hit_distance - 3 * return_normals
    _, color0, normal0, _ = field_layout(D, use_hit_distance, return_normals)
    D_mat = D - 1 if use_hit_distance else D
    D_out = D + 3 * return_normals
    dev = fields.device
    out = torch.zeros((n_images, height, width, D_out), dtype=torch.float32, device=dev)
    out_t = torch.zeros((n_images, height, width), dtype=torch.float32, device=dev)
    for starts, counts, ids, L in _batches(bounds, n_images * tiles_w * tiles_h, tiles, budget):
        rb = _ray_batch(fields, starts, counts, ids, L, rays, tiles_w, tiles_w * tiles_h, width,
                        height, use_hit_distance)
        vals = [rb.g[color0 + k][:, None, :].expand_as(rb.alpha) for k in range(D_mat)]
        if use_hit_distance:
            vals.append(rb.hd)
        if return_normals:
            sgn = _normal_sign(rb, normal0)
            vals += [(sgn, rb.g[normal0 + k][:, None, :]) for k in range(3)]
        acc = [torch.zeros(rb.t_final.shape, dtype=torch.float32, device=dev) for _ in vals]
        for jj in range(L):
            lv = rb.live[..., jj]
            w = rb.weights[..., jj]
            for k, v in enumerate(vals):
                if isinstance(v, tuple):  # a normal: the weight's sign flips toward the ray
                    term = torch.where(v[0][..., jj] > 0, w, -w) * v[1][..., jj]
                else:
                    term = w * v[..., jj]
                acc[k] = torch.where(lv, acc[k] + term, acc[k])
        inside = rb.inside
        at = tuple(a[inside] for a in rb.at)
        out[at] = torch.stack(acc, dim=-1)[inside]
        out_t[at] = rb.t_final[inside]
    return out, out_t


def _check_args(name, fields, bounds, rays, n_images, tiles_w, tiles_h, width, height,
                use_hit_distance, return_normals):
    """Validate what K7a and K7b share; returns (D, n_tiles)."""
    if fields.dim() != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be a contiguous float32 [F, P] tensor")
    D = fields.shape[0] - ROW_SCALE - 3 * bool(use_hit_distance) - 3 * bool(return_normals)
    if D < 1:
        raise ValueError(f"{name} takes at least one channel, got D={D}")
    n_tiles = n_images * tiles_w * tiles_h
    if bounds.shape != (n_tiles + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [{n_tiles + 1}], got {bounds.dtype} "
                         f"{tuple(bounds.shape)}")
    shape = (n_images, height, width, 6)
    if tuple(rays.shape) != shape or rays.dtype != torch.float32 or not rays.is_contiguous():
        raise ValueError(f"rays must be a contiguous float32 {shape} tensor, got "
                         f"{rays.dtype} {tuple(rays.shape)}")
    return D, n_tiles


def _group_fields(fields: torch.Tensor, D: int, c0: int, c1: int, hit: bool,
                  normals: bool) -> torch.Tensor:
    """The slot rows of channels [c0, c1) with the 13 geometry rows; the
    last group (c1 == D) also takes the scale rows (with `hit`) and the
    normal rows (with `normals`), the other groups neither."""
    _, color0, normal0, _ = field_layout(D, hit, normals)
    last = c1 == D
    rows = [fields[:ROW_SCALE]]
    if last and hit:
        rows.append(fields[ROW_SCALE:color0])
    rows.append(fields[color0 + c0 : color0 + c1])
    if last and normals:
        rows.append(fields[normal0:])
    return torch.cat(rows)


def rasterize_eval3d_fwd(
    fields: torch.Tensor,  # [F, P] f32 sorted slot rows
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans in the sorted stream
    rays: torch.Tensor,  # [I, H, W, 6] f32 world-space rays
    n_images: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
    use_hit_distance: bool = False,
    return_normals: bool = False,
    pair_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
    eval_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only, with pair_counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite every 16x16 tile front to back along the pixels' rays.

    Returns (out [I, H, W, D + 3*normals] f32, T_final [I, H, W] f32).  On
    the card, `pair_counts` receives each tile's contributing (pixel, slot)
    pairs, which the backward's live pairs must equal, and `eval_counts` the
    pairs it evaluated.  More than MAX_CHANNELS channels composite in
    `channel_groups`, each with the geometry rows; the hit channel (the last
    of D) and the normals ride in the last group.  T and the counters come
    from the first group.
    """
    D, n_tiles = _check_args("rasterize_eval3d_fwd", fields, bounds, rays, n_images, tiles_w,
                             tiles_h, width, height, use_hit_distance, return_normals)
    if D > MAX_CHANNELS:
        hit, nrm = bool(use_hit_distance), bool(return_normals)
        outs = [rasterize_eval3d_fwd(
                    _group_fields(fields, D, c0, c1, hit, nrm), bounds, rays, n_images, tiles_w,
                    tiles_h, width, height, hit and c1 == D, nrm and c1 == D,
                    *((pair_counts, eval_counts) if c0 == 0 else (None, None)))
                for c0, c1 in channel_groups(D)]
        return torch.cat([o[0] for o in outs], dim=-1), outs[0][1]
    if not check_kernel_device("rasterize_eval3d_fwd", fields, bounds, rays):
        if pair_counts is not None or eval_counts is not None:
            raise ValueError("pair_counts and eval_counts are filled by the CUDA kernel only")
        return rasterize_eval3d_fwd_plain(fields, bounds, rays, n_images, tiles_w, tiles_h,
                                          width, height, use_hit_distance, return_normals)
    if eval_counts is not None and pair_counts is None:
        raise ValueError("eval_counts comes with pair_counts")
    lib = _build.load("rasterize_eval3d_fwd")
    dev = fields.device
    out = torch.empty((n_images, height, width, D + 3 * return_normals), dtype=torch.float32,
                      device=dev)
    out_t = torch.empty((n_images, height, width), dtype=torch.float32, device=dev)
    if pair_counts is not None and eval_counts is None:
        eval_counts = torch.empty_like(pair_counts)
    code = lib.gs_rasterize_eval3d_fwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), rays.data_ptr(), D,
        int(use_hit_distance), int(return_normals), tiles_w, tiles_w * tiles_h, width, height,
        n_tiles, out.data_ptr(), out_t.data_ptr(), _counts_ptr(pair_counts, n_tiles, dev),
        _counts_ptr(eval_counts, n_tiles, dev), _build.stream_of(out),
    )
    _build.check(lib, code, "rasterize_eval3d_fwd")
    rasterize_eval3d_fwd.launches += 1
    return out, out_t


rasterize_eval3d_fwd.launches = 0


# ---------------------------------------------------------------------------
# K7b: per-slot gradients at the sorted positions and per-pixel ray gradients
# ---------------------------------------------------------------------------


def rasterize_eval3d_bwd_plain(
    fields: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor, n_images: int, tiles_w: int,
    tiles_h: int, width: int, height: int, use_hit_distance: bool, return_normals: bool,
    v_pix: torch.Tensor, v_t: torch.Tensor, pix_out: torch.Tensor, t_final: torch.Tensor,
    tiles: Optional[torch.Tensor] = None, budget: int = PLAIN_BUDGET,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain version of K7b: the forward's replay (`_ray_batch`), then the
    per-pair gradient terms, operation by operation as the kernel, summed
    over each tile's pixels and, serially, over each pixel's slots.
    Returns (v_slot [F, P], v_rays [I, H, W, 6], live (pixel, slot) pairs);
    with `tiles`, of those tiles' slots and pixels only."""
    F, P = fields.shape
    hit, nrm = bool(use_hit_distance), bool(return_normals)
    D = F - ROW_SCALE - 3 * hit - 3 * nrm
    _, color0, normal0, scale0 = field_layout(D, hit, nrm)
    D_mat = D - 1 if hit else D
    dev = fields.device
    v_slot = torch.zeros((F, P), dtype=torch.float32, device=dev)
    v_rays = torch.zeros((n_images, height, width, 6), dtype=torch.float32, device=dev)
    n_live = 0
    for starts, counts, ids, L in _batches(bounds, n_images * tiles_w * tiles_h, tiles, budget):
        rb = _ray_batch(fields, starts, counts, ids, L, rays, tiles_w, tiles_w * tiles_h, width,
                        height, hit)
        vp = v_pix[rb.at]  # [nt, n_pix, D_out]
        po = pix_out[rb.at]
        dtot = torch.zeros_like(rb.t_final)  # v_ch . out, serial over the channels
        for k in range(vp.shape[-1]):
            dtot = dtot + vp[..., k] * po[..., k]
        dtot = dtot[..., None]
        vt_term = (v_t[rb.at] * t_final[rb.at])[..., None]
        w, alpha, tb, live = rb.weights, rb.alpha, rb.t_before, rb.live

        d = torch.zeros_like(w)  # v_ch . value, serial over the channels
        for k in range(D_mat):
            d = d + vp[..., k, None] * rb.g[color0 + k][:, None, :]
        if hit:
            d = d + vp[..., D - 1, None] * rb.hd
        if nrm:
            sgn = _normal_sign(rb, normal0)
            for k in range(3):
                d = d + vp[..., D + k, None] * (sgn * rb.g[normal0 + k][:, None, :])
        wd = w * d
        e_incl = torch.empty_like(w)  # the prefix of w d over live pairs, serial
        E = torch.zeros_like(rb.t_final)
        for jj in range(L):
            E = torch.where(live[..., jj], E + wd[..., jj], E)
            e_incl[..., jj] = E
        ra = 1.0 / (1.0 - alpha)  # alpha <= 0.99
        v_alpha = torch.where(live, d * tb - (dtot - e_incl) * ra - vt_term * ra, 0.0)
        grad_ok = live & rb.unclamped
        v_sigma = torch.where(grad_ok, -alpha * v_alpha, 0.0)
        v_op = torch.where(grad_ok, rb.vis * v_alpha, 0.0)
        v_c = tuple(v_sigma * ck for ck in rb.c)
        v_uh = list(_cross(rb.gv, v_c))
        v_g = list(_cross(v_c, rb.uh))
        v_hitt = torch.zeros_like(w)
        scale_rows = []
        if hit:
            v_hd = torch.where(live, w * vp[..., D - 1, None], 0.0)
            v_hitt = v_hd * rb.q
            v_q = v_hd * rb.hit_t
            inv_q = 1.0 / rb.q
            for k in range(3):
                s_k = rb.g[scale0 + k][:, None, :]
                v_b = v_q * (s_k * rb.uh[k]) * inv_q
                v_uh[k] = v_uh[k] + v_b * s_k
                scale_rows.append((v_b * rb.uh[k]).sum(1))
        for k in range(3):
            v_uh[k] = v_uh[k] - rb.gv[k] * v_hitt
            v_g[k] = v_g[k] - rb.uh[k] * v_hitt
        udotv = _dot3(rb.uh, v_uh)
        v_u = [rb.inv_un * (v_uh[k] - rb.uh[k] * udotv) for k in range(3)]

        m = [rb.g[ROW_M + i] for i in range(9)]  # [nt, L]
        S = [v_g[k].sum(1) for k in range(3)]
        rows = [-(m[j] * S[0] + m[3 + j] * S[1] + m[6 + j] * S[2]) for j in range(3)]
        rows += [(v_u[k] * rb.d[j] + v_g[k] * (rb.o[j] - rb.g[ROW_X + j][:, None, :])).sum(1)
                 for k in range(3) for j in range(3)]
        rows.append(v_op.sum(1))
        rows += scale_rows
        rows += list(torch.einsum("tpc,tpl->ctl", vp[..., :D_mat], w))
        if hit:
            rows.append(torch.zeros_like(w[:, 0]))  # the input hit channel's row
        if nrm:
            rows += list(torch.einsum("tpk,tpl->ktl", vp[..., D : D + 3], w * sgn))
        grads = torch.stack(rows)  # [F, nt, L]
        v_slot[:, rb.idx[rb.valid]] = grads[:, rb.valid]

        # the ray gradients M^T v_g and M^T v_u, summed serially over the live slots
        mp = [mi[:, None, :] for mi in m]
        terms = torch.stack([_dot3((mp[j], mp[3 + j], mp[6 + j]), v) for v in (v_g, v_u)
                             for j in range(3)])  # [6, nt, n_pix, L]
        v_ray = torch.zeros_like(terms[..., 0])
        for jj in range(L):
            v_ray = torch.where(live[..., jj], v_ray + terms[..., jj], v_ray)
        inside = rb.inside
        v_rays[tuple(a[inside] for a in rb.at)] = v_ray.movedim(0, -1)[inside]
        n_live += int(live.sum())
    return v_slot, v_rays, n_live


def rasterize_eval3d_bwd(
    fields: torch.Tensor,  # [F, P] f32 sorted slot rows, as the forward read them
    bounds: torch.Tensor,  # [n_tiles+1] i32 tile spans
    rays: torch.Tensor,  # [I, H, W, 6] f32
    n_images: int,
    tiles_w: int,
    tiles_h: int,
    width: int,
    height: int,
    use_hit_distance: bool,
    return_normals: bool,
    v_pix: torch.Tensor,  # [I, H, W, D + 3*normals] cotangent of the forward's out
    v_t: torch.Tensor,  # [I, H, W] cotangent of T_final
    pix_out: torch.Tensor,  # [I, H, W, D + 3*normals] the forward's out
    t_final: torch.Tensor,  # [I, H, W] the forward's T_final
    live_counts: Optional[torch.Tensor] = None,  # [n_tiles] i32, CUDA only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-slot gradients of the F field rows at the sorted positions [F, P]
    f32, zero for slots outside every span; per-pixel ray gradients [I, H, W,
    6] f32).  The same inputs give the same bits from run to run.  On the
    card, `live_counts` receives each tile's count of live (pixel, slot)
    pairs.  More than MAX_CHANNELS channels run in the forward's
    `channel_groups`, each with its channels' cotangents (the last with the
    normals'), v_t in the first only (`live_counts` from the first); the
    geometry rows' and the ray gradients add over the groups in float32, in
    group order."""
    D, n_tiles = _check_args("rasterize_eval3d_bwd", fields, bounds, rays, n_images, tiles_w,
                             tiles_h, width, height, use_hit_distance, return_normals)
    D_out = D + 3 * bool(return_normals)
    img = (n_images, height, width)
    for name, t, shape in (("v_pix", v_pix, img + (D_out,)), ("v_t", v_t, img),
                           ("pix_out", pix_out, img + (D_out,)), ("t_final", t_final, img)):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if D > MAX_CHANNELS:
        hit, nrm = bool(use_hit_distance), bool(return_normals)
        slots, v_rays = [], None
        for c0, c1 in channel_groups(D):
            last = c1 == D
            end = D_out if last else c1  # the last group's channels end with the normals
            v_g, r_g = rasterize_eval3d_bwd(
                _group_fields(fields, D, c0, c1, hit, nrm), bounds, rays, n_images, tiles_w,
                tiles_h, width, height, hit and last, nrm and last,
                v_pix[..., c0:end].contiguous(), v_t if c0 == 0 else torch.zeros_like(v_t),
                pix_out[..., c0:end].contiguous(), t_final, live_counts if c0 == 0 else None)
            slots.append(v_g)
            v_rays = r_g if v_rays is None else v_rays.add_(r_g)
        # the scale rows (with hit) and the normal rows from the last group,
        # which alone has them, around every group's channel rows
        scale_end = ROW_SCALE + 3 * hit
        rows = ([_add_groups(slots, ROW_SCALE), slots[-1][ROW_SCALE:scale_end]]
                + [v[ROW_SCALE:] for v in slots[:-1]] + [slots[-1][scale_end:]])
        return torch.cat(rows), v_rays
    if not check_kernel_device("rasterize_eval3d_bwd", fields, bounds, rays, v_pix, v_t, pix_out,
                               t_final):
        if live_counts is not None:
            raise ValueError("live_counts is filled by the CUDA kernel only")
        return rasterize_eval3d_bwd_plain(fields, bounds, rays, n_images, tiles_w, tiles_h, width,
                                          height, use_hit_distance, return_normals, v_pix, v_t,
                                          pix_out, t_final)[:2]
    lib = _build.load("rasterize_eval3d_bwd")
    dev = fields.device
    # the kernel writes every element, zeros where no live pair reaches,
    # when there is a tile to write them
    alloc = torch.empty if n_tiles > 0 else torch.zeros
    v_slot = alloc(fields.shape, dtype=torch.float32, device=dev)
    v_rays = alloc(img + (6,), dtype=torch.float32, device=dev)
    code = lib.gs_rasterize_eval3d_bwd(
        fields.data_ptr(), fields.shape[1], bounds.contiguous().data_ptr(), rays.data_ptr(), D,
        int(use_hit_distance), int(return_normals), tiles_w, tiles_w * tiles_h, width, height,
        n_tiles, v_pix.data_ptr(), v_t.data_ptr(), pix_out.data_ptr(), t_final.data_ptr(),
        v_slot.data_ptr(), v_rays.data_ptr(), _counts_ptr(live_counts, n_tiles, dev),
        _build.stream_of(v_slot),
    )
    _build.check(lib, code, "rasterize_eval3d_bwd")
    rasterize_eval3d_bwd.launches += 1
    return v_slot, v_rays


rasterize_eval3d_bwd.launches = 0
