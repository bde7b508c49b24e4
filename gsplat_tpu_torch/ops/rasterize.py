"""rasterize_to_pixels: the tile rasterization op (forward).

Port of `gsplat_tpu/ops/rasterize.py` (make_tight_plan :196-342, the
forward of rasterize_to_pixels :630-784).  The forward runs:

  1. the compaction sort: visible gaussians first, front to back (a stable
     sort on where(visible, depth, inf), the JAX package's (culled, depth,
     index) key);
  2. the tight plan: per (gaussian, covered tile row) records with the
     exact tile-column interval of the alpha >= 1/255 ellipse
     (kernel K3, ops/gather_kernel.py:expand_rows);
  3. the emission: per slot a tile key and the gaussian's render fields
     (kernel K4, ops/gather_kernel.py:expand_emission);
  4. a stable sort by tile key.  Gaussians are already in depth order, so
     the stable order within a tile is front to back;
  5. per-tile spans by searchsorted, then the composite (kernel K1,
     ops/rasterize_kernel.py:rasterize_fwd), which writes the image layout
     directly.

Capacities are static, as in the JAX package: `isect_capacity` bounds the
emission slots and `row_capacity` the row records; `isect_overflow` says
whether either truncated.  Sorts, cumsum, searchsorted and the gathers are
PyTorch calls.  The backward belongs to the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .gather_kernel import expand_emission, expand_rows
from .projection import ALPHA_THRESHOLD
from .rasterize_kernel import rasterize_fwd

TILE = 16  # default tile size (pixels per side)
CH = 512  # capacity rounding unit, as the JAX package's gather_pallas.CH


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=torch.int32)


class Compacted(NamedTuple):
    """Gaussians in compaction order: visible first, front to back."""

    perm: torch.Tensor  # [E] original row per compacted row
    means2d: torch.Tensor  # [E, 2]
    radii: torch.Tensor  # [E, 2] int32
    conics: torch.Tensor  # [E, 3]
    opacities: torch.Tensor  # [E]
    colors: torch.Tensor  # [E, D]
    image_ids: torch.Tensor  # [E] int32
    n_live: torch.Tensor  # [] int32 visible rows (a prefix)


def compact_by_depth(means2d, conics, colors, opacities, radii, depths) -> Compacted:
    """The compaction sort (rasterize.py:688-710): ties keep index order."""
    I, N = means2d.shape[0], means2d.shape[1]
    E = I * N
    D = colors.shape[-1]
    rad = radii.reshape(E, 2)
    alive = (rad > 0).all(dim=-1)
    key = torch.where(alive, depths.detach().reshape(E), float("inf"))
    _, perm = torch.sort(key, stable=True)
    take = lambda x, d: x.detach().reshape(E, d).index_select(0, perm)
    return Compacted(
        perm=perm,
        means2d=take(means2d, 2),
        radii=rad.index_select(0, perm),
        conics=take(conics, 3),
        opacities=take(opacities, 1)[:, 0],
        colors=take(colors, D),
        image_ids=(perm // N).to(torch.int32),
        n_live=alive.sum().to(torch.int32),
    )


class RowGeometry(NamedTuple):
    """Inputs of K3 (expand_rows) and what the plan keeps beside them."""

    gg_f: torch.Tensor  # [10, E] f32 (gather_kernel.GF_* rows)
    gg_i: torch.Tensor  # [6, E] i32 (gather_kernel.GI_* rows)
    n_rows: torch.Tensor  # [1] i32
    dummy: torch.Tensor  # [E] bool: no real coverage
    prefix: torch.Tensor  # [E] bool: visible prefix
    row_overflow: torch.Tensor  # [] bool


def row_geometry(
    means2d, radii, conics, opacities, im_g, n_live, n_images: int,
    tile_size: int, tile_width: int, tile_height: int, row_cap: int,
) -> RowGeometry:
    """Per-gaussian tile rows and ellipse geometry (rasterize.py:210-308)."""
    E = means2d.shape[0]
    I = n_images
    ts = float(tile_size)
    dev = means2d.device

    # conservative AABB rect from the projection radii (also the fallback)
    tmean = means2d / ts
    trad = radii.to(means2d.dtype) / ts
    tmin = torch.floor(tmean - trad).to(torch.int32)
    tmax = torch.ceil(tmean + trad).to(torch.int32)
    tminx = torch.clamp(tmin[:, 0], 0, tile_width)
    tminy = torch.clamp(tmin[:, 1], 0, tile_height)
    tmaxx = torch.clamp(tmax[:, 0], 0, tile_width)
    tmaxy = torch.clamp(tmax[:, 1], 0, tile_height)
    alive = (radii > 0).all(dim=-1) & (tmaxx > tminx) & (tmaxy > tminy)

    # tight ellipse extents: alpha >= 1/255  <=>  sigma <= log(op / thr)
    a, b, c = conics.unbind(-1)
    mx, my = means2d.unbind(-1)
    sig_max = torch.log(torch.clamp(opacities, min=ALPHA_THRESHOLD) / ALPHA_THRESHOLD)
    sig_max = sig_max * (1.0 + 1e-5) + 1e-6
    det = a * c - b * b
    conic_ok = (
        torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
        & (a > 1e-12) & (c > 1e-12) & (det > 1e-18) & (sig_max > 0)
    )
    a_s = torch.where(conic_ok, a, 1.0)
    b_s = torch.where(conic_ok, b, 0.0)
    c_s = torch.where(conic_ok, c, 1.0)
    det_s = torch.where(conic_ok, det, 1.0)
    sig_s = torch.where(conic_ok, sig_max, 1.0)
    yext = torch.sqrt(2.0 * sig_s * a_s / det_s) * (1.0 + 1e-5) + 1e-3
    xext = torch.sqrt(2.0 * sig_s * c_s / det_s) * (1.0 + 1e-5) + 1e-3

    my_s = torch.where(alive, my, 0.0)
    mx_s = torch.where(alive, mx, 0.0)
    ry0 = torch.floor((my_s - yext) / ts).to(torch.int32)
    ry0 = torch.minimum(torch.maximum(ry0, tminy), tmaxy)
    ry1 = torch.ceil((my_s + yext) / ts).to(torch.int32)
    ry1 = torch.minimum(torch.maximum(ry1, ry0), tmaxy)
    use_aabb = alive & ~conic_ok
    ry0 = torch.where(use_aabb, tminy, ry0)
    ry1 = torch.where(use_aabb, tmaxy, ry1)
    h_t = torch.where(alive, ry1 - ry0, 0)
    dummy = h_t == 0
    # Rows exist only for the visible prefix; a prefix gaussian with no real
    # coverage still holds one dummy record.  The culled suffix holds none.
    prefix = torch.arange(E, device=dev) < n_live
    h_pad = torch.where(prefix, torch.clamp(h_t, min=1), 0).to(torch.int32)

    gh_in = _cumsum_i32(h_pad)
    gh_ex = gh_in - h_pad
    n_rows_total = gh_in[-1]
    n_rows = torch.clamp(n_rows_total, max=row_cap).reshape(1)
    im_eff = torch.where(dummy, I, im_g).to(torch.int32)

    gg_f = torch.stack(
        [mx_s, my_s, a_s, b_s, c_s, sig_s, yext, xext, det_s, use_aabb.to(torch.float32)]
    ).contiguous()
    gg_i = torch.stack([gh_ex, gh_in, ry0, im_eff, tminx, tmaxx]).to(torch.int32).contiguous()
    return RowGeometry(
        gg_f=gg_f, gg_i=gg_i, n_rows=n_rows.to(torch.int32), dummy=dummy, prefix=prefix,
        row_overflow=n_rows_total > row_cap,
    )


class TightPlan(NamedTuple):
    """Static-shape tight emission layout (rasterize.py:170-193)."""

    rr: torch.Tensor  # [6, row_cap] i32 (gather_kernel.RR_* rows)
    n_slots: torch.Tensor  # [1] i32 live emission slots (<= cap_total)
    dummy: torch.Tensor  # [E] bool: no real coverage
    n_isects: torch.Tensor  # [] tight intersections before truncation
    overflow: torch.Tensor  # [] bool


def make_tight_plan(
    means2d, radii, conics, opacities, im_g, n_live, n_images: int,
    tile_size: int, tile_width: int, tile_height: int, cap_total: int, row_cap: int,
) -> TightPlan:
    """Row records for the compacted gaussians (rasterize.py:196-342).

    Dummy records and slots count against the capacities, so n_isects and
    isect_overflow agree with the JAX package.
    """
    geo = row_geometry(
        means2d, radii, conics, opacities, im_g, n_live, n_images,
        tile_size, tile_width, tile_height, row_cap,
    )
    x0, ty, im, w, gid = expand_rows(
        geo.gg_f, geo.gg_i, geo.n_rows, row_cap, tile_size, n_images
    )
    rr_cum_in = _cumsum_i32(w)
    rr_cum_ex = rr_cum_in - w
    total = rr_cum_in[-1]
    n_dummy = (geo.dummy & geo.prefix).sum().to(torch.int32)
    return TightPlan(
        rr=torch.stack([rr_cum_ex, rr_cum_in, x0, ty, im, gid]).contiguous(),
        n_slots=torch.clamp(total, max=cap_total).reshape(1).to(torch.int32),
        dummy=geo.dummy,
        n_isects=total - torch.minimum(n_dummy, total),
        overflow=(total > cap_total) | geo.row_overflow,
    )


def field_table(comp: Compacted, dummy: torch.Tensor) -> torch.Tensor:
    """Render fields [6+D, E] in compaction order, zero for gaussians with no
    coverage (those may carry NaN; rasterize.py:386-406)."""
    rows = torch.cat(
        [comp.means2d, comp.conics, comp.opacities[:, None], comp.colors], dim=1
    ).t()
    return torch.where(dummy[None], 0.0, rows).contiguous()


def sort_slots(keys: torch.Tensor, fields: torch.Tensor, n_tiles: int):
    """Stable sort of the emission slots by tile key, then per-tile spans.

    Returns (sorted fields [F, cap], bounds int32 [n_tiles+1]).
    """
    keys_s, order = torch.sort(keys, stable=True)
    fields_s = fields.index_select(1, order)
    probes = torch.arange(n_tiles + 1, dtype=torch.int32, device=keys.device)
    bounds = torch.searchsorted(keys_s, probes, side="left", out_int32=True)
    return fields_s, bounds


class _RasterizeCore(torch.autograd.Function):
    """Emission, sort and composite.  The differentiable inputs (means2d,
    conics, colors, opacities) fix the gradient layout for the training
    slice; the forward reads the compacted field table."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, table_g, rr, n_slots,
                cap_total, tile_size, tile_width, tile_height, n_images, width, height):
        T = n_images * tile_width * tile_height
        keys, fields = expand_emission(
            rr, table_g, n_slots, cap_total, tile_width, tile_width * tile_height, T
        )
        fields_s, bounds = sort_slots(keys, fields, T)
        return rasterize_fwd(
            fields_s, bounds, n_images, tile_size, tile_width, tile_height, width, height
        )

    @staticmethod
    def backward(ctx, v_colors, v_t):
        raise NotImplementedError(
            "the rasterizer's backward (kernels K2 and K5) belongs to the "
            "training slice, ROADMAP Queue 1 item 2"
        )


def rasterize_to_pixels(
    means2d: torch.Tensor,  # [I, N, 2]
    conics: torch.Tensor,  # [I, N, 3]
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    image_width: int,
    image_height: int,
    radii: torch.Tensor,  # [I, N, 2] int32 (0 = culled)
    depths: torch.Tensor,  # [I, N]
    isect_capacity: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    masks: Optional[torch.Tensor] = None,  # [I, th, tw] bool
    tile_size: int = TILE,
    absgrad: bool = False,
    means2d_abs: Optional[torch.Tensor] = None,
    row_capacity: Optional[int] = None,
    pack_payload: Optional[bool] = None,
    pack_grads: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Rasterize projected gaussians to images (sorting included).

    Returns (render_colors [I, H, W, D], render_alphas [I, H, W, 1], aux)
    with aux = {n_isects, isect_overflow, tiles_per_gauss}.  `row_capacity`
    defaults to isect_capacity // 2.  Masked-off tiles show pure background
    with zero alpha.
    """
    if absgrad or means2d_abs is not None:
        raise NotImplementedError(
            "absgrad belongs to the training slice, ROADMAP Queue 1 item 2"
        )
    if pack_payload or pack_grads:
        raise NotImplementedError(
            "packed sort payloads / gradients are ROADMAP Queue 1 item 5"
        )
    if tile_size not in (8, 16, 32):
        raise ValueError(f"tile_size must be 8, 16 or 32, got {tile_size}")
    I, N = means2d.shape[0], means2d.shape[1]
    E = I * N
    D = colors.shape[-1]
    th = -(-image_height // tile_size)
    tw = -(-image_width // tile_size)
    cap_total = _round_up(isect_capacity, CH)
    if row_capacity is None:
        row_capacity = isect_capacity // 2
    row_cap = _round_up(max(row_capacity, 1), CH)

    comp = compact_by_depth(means2d, conics, colors, opacities, radii, depths)
    plan = make_tight_plan(
        comp.means2d, comp.radii, comp.conics, comp.opacities, comp.image_ids,
        comp.n_live, I, tile_size, tw, th, cap_total, row_cap,
    )
    color_img, t_img = _RasterizeCore.apply(
        means2d.reshape(E, 2), conics.reshape(E, 3), colors.reshape(E, D),
        opacities.reshape(E), field_table(comp, plan.dummy), plan.rr, plan.n_slots,
        cap_total, tile_size, tw, th, I, image_width, image_height,
    )
    t_img = t_img[..., None]
    render = color_img
    render_alphas = 1.0 - t_img
    if backgrounds is not None:
        render = render + t_img * backgrounds[:, None, None, :]
    if masks is not None:
        mpix = masks.repeat_interleave(tile_size, dim=1).repeat_interleave(tile_size, dim=2)
        mpix = mpix[:, :image_height, :image_width, None]
        bg = (
            backgrounds[:, None, None, :]
            if backgrounds is not None
            else torch.zeros((I, 1, 1, D), dtype=render.dtype, device=render.device)
        )
        render = torch.where(mpix, render, bg)
        render_alphas = torch.where(mpix, render_alphas, 0.0)

    # conservative AABB tile counts in the caller's order
    m2 = means2d.detach().reshape(E, 2)
    rad = radii.reshape(E, 2)
    tmean = m2 / tile_size
    trad = rad.to(m2.dtype) / tile_size
    tmn = torch.floor(tmean - trad).to(torch.int32)
    tmx = torch.ceil(tmean + trad).to(torch.int32)
    wb = torch.clamp(tmx[:, 0], 0, tw) - torch.clamp(tmn[:, 0], 0, tw)
    hb = torch.clamp(tmx[:, 1], 0, th) - torch.clamp(tmn[:, 1], 0, th)
    aabb_ok = (rad > 0).all(dim=-1) & (wb > 0) & (hb > 0)
    aabb_cnt = torch.where(aabb_ok, wb * hb, 0)

    aux = {
        "n_isects": plan.n_isects,
        "isect_overflow": plan.overflow,
        "tiles_per_gauss": aabb_cnt.reshape(I, N).to(torch.int32),
    }
    return render, render_alphas, aux
