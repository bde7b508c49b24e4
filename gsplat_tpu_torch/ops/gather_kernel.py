"""Tight-plan row expansion (K3), emission expansion (K4), AABB emission
expansion (K8) and the row gather into sorted order (K9).

Wrappers for `csrc/expand.cu` (K3, K4, K8) and `csrc/align.cu` (K9), each
with its plain PyTorch version.  On a CUDA tensor a wrapper launches its
kernel (or raises); the plain version runs only for CPU tensors.  Each
wrapper counts its launches in `<wrapper>.launches`.

K3 `expand_rows` replaces gsplat_tpu/ops/gather_pallas.py:_expand_rows_kernel
(:396, wrapper :526); K4 `expand_emission` replaces
gather_pallas.py:_expand2_kernel (:584, wrapper expand_emission2 :721), in
its float32 layout and (`packed=True`, :691-716) its bf16-pair layout with
tile-local means, whose launches count in `expand_emission.launches_packed`;
K8 `expand_emission_aabb` replaces _expand_kernel (:120, wrapper
expand_emission :216; K4 took that name here first), with or without its
field table; K9 replaces _align_kernel (:274, wrapper :316) as
`gather_records`, the paths' gather of gaussian-major records through the
sort, and as `align_rows`, the JAX-shaped gather of a field-major table.
The TPU kernels'
windowed one-hot selection and hi/lo integer transport are TPU workarounds
and are not ported: the CUDA kernels find their source row by binary search
and read it directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .._device import check_kernel_device
from .bf16pair import pack_rows

# K3 table columns: float gg_f [10, E] and int gg_i [6, E].
GF_MX, GF_MY, GF_A, GF_B, GF_C, GF_SIG, GF_YEXT, GF_XEXT, GF_DET, GF_AABB = range(10)
GI_EX, GI_IN, GI_RY0, GI_IM, GI_TMINX, GI_TMAXX = range(6)
# K4 row-record table rr [6, R].
RR_EX, RR_IN, RR_X0, RR_TY, RR_IM, RR_GID = range(6)


def _check_table(name, t, rows, dtype):
    if t.dim() != 2 or t.shape[0] != rows or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} [{rows}, n] tensor, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def _check_count(name, t):
    if t.shape != (1,) or t.dtype != torch.int32:
        raise ValueError(f"{name} must be an int32 [1] tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K3: per (gaussian, covered tile row) records
# ---------------------------------------------------------------------------


def expand_rows_plain(
    gg_f: torch.Tensor, gg_i: torch.Tensor, n_rows: torch.Tensor, row_cap: int,
    tile_size: int, n_images: int,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K3: (x0, ty, im, w, gid), each int32 [row_cap]."""
    E = gg_f.shape[1]
    dev = gg_f.device
    if E == 0:  # no gaussian: every record is empty
        zero = torch.zeros(row_cap, dtype=torch.int32, device=dev)
        return zero, zero.clone(), torch.full_like(zero, n_images), zero.clone(), zero.clone()
    r = torch.arange(row_cap, dtype=torch.int32, device=dev)
    g = torch.searchsorted(gg_i[GI_IN].contiguous(), r, right=True)
    found = (r < n_rows) & (g < E)
    gc = torch.clamp(g, max=E - 1)
    gf = gg_f[:, gc]
    gi = gg_i[:, gc]
    ts = float(tile_size)

    ty = gi[GI_RY0] + (r - gi[GI_EX])
    tminx, tmaxx = gi[GI_TMINX], gi[GI_TMAXX]
    mx, my = gf[GF_MX], gf[GF_MY]
    a = torch.clamp(gf[GF_A], min=1e-12)
    b = gf[GF_B]
    c = torch.clamp(gf[GF_C], min=1e-12)
    sig, yext, xext, det = gf[GF_SIG], gf[GF_YEXT], gf[GF_XEXT], gf[GF_DET]

    u0 = ty.to(torch.float32) * ts - my
    u1 = u0 + ts
    uc0 = torch.minimum(torch.maximum(u0, -yext), yext)
    uc1 = torch.minimum(torch.maximum(u1, -yext), yext)

    def disc(u):
        return torch.clamp(2.0 * sig * a - det * u * u, min=0.0)

    def dx_hi(u):
        return (-b * u + torch.sqrt(disc(u))) / a

    def dx_lo(u):
        return (-b * u - torch.sqrt(disc(u))) / a

    u_star_hi = -(b / c) * xext
    u_star_lo = (b / c) * xext
    hi = torch.maximum(dx_hi(uc0), dx_hi(uc1))
    hi = torch.where((u_star_hi >= uc0) & (u_star_hi <= uc1), xext, hi)
    lo = torch.minimum(dx_lo(uc0), dx_lo(uc1))
    lo = torch.where((u_star_lo >= uc0) & (u_star_lo <= uc1), -xext, lo)
    hi = hi + 1e-3
    lo = lo - 1e-3

    x0 = torch.floor((mx + lo) / ts).to(torch.int32)
    x0 = torch.minimum(torch.maximum(x0, tminx), torch.maximum(tmaxx - 1, tminx))
    x1 = torch.ceil((mx + hi) / ts).to(torch.int32)
    x1 = torch.minimum(torch.maximum(x1, x0 + 1), tmaxx)
    aabb = gf[GF_AABB] > 0.5
    x0 = torch.where(aabb, tminx, x0)
    x1 = torch.where(aabb, tmaxx, x1)
    w = torch.clamp(x1 - x0, min=1)

    im = gi[GI_IM]
    dummy = im == n_images
    zero = torch.zeros_like(x0)
    x0 = torch.where(dummy, zero, x0)
    ty = torch.where(dummy, zero, ty)
    w = torch.where(dummy, torch.ones_like(w), w)

    x0 = torch.where(found, x0, zero)
    ty = torch.where(found, ty, zero)
    im = torch.where(found, im, torch.full_like(im, n_images))
    w = torch.where(found, w, zero)
    gid = torch.where(found, gc.to(torch.int32), zero)
    return x0, ty, im, w, gid


def expand_rows(
    gg_f: torch.Tensor,  # [10, E] f32 per-gaussian geometry (GF_* rows)
    gg_i: torch.Tensor,  # [6, E] i32 row-count cumsums and tile bounds (GI_* rows)
    n_rows: torch.Tensor,  # [1] i32 live row records
    row_cap: int,
    tile_size: int,
    n_images: int,
) -> Tuple[torch.Tensor, ...]:
    """Expand per-gaussian geometry to per-tile-row interval records.

    Returns (x0, ty, im, w, gid), each int32 [row_cap].  Records past
    n_rows are (0, 0, n_images, 0, 0); dummy gaussians (im == n_images)
    hold one record (0, 0, n_images, 1, gid).
    """
    _check_table("gg_f", gg_f, 10, torch.float32)
    _check_table("gg_i", gg_i, 6, torch.int32)
    _check_count("n_rows", n_rows)
    if not check_kernel_device("expand_rows", gg_f, gg_i, n_rows):
        return expand_rows_plain(gg_f, gg_i, n_rows, row_cap, tile_size, n_images)
    lib = _build.load("expand")
    out = torch.empty((5, row_cap), dtype=torch.int32, device=gg_f.device)
    # the gaussian of each 256-row CTA's first row, the search's brackets
    br = torch.empty((-(-row_cap // 256) + 1,), dtype=torch.int64, device=gg_f.device)
    code = lib.gs_expand_rows(
        gg_f.data_ptr(), gg_i.data_ptr(), gg_f.shape[1], n_rows.data_ptr(),
        row_cap, float(tile_size), n_images, br.data_ptr(), br.shape[0], out.data_ptr(),
        _build.stream_of(out),
    )
    _build.check(lib, code, "expand_rows")
    expand_rows.launches += 1
    return tuple(out.unbind(0))


expand_rows.launches = 0


# ---------------------------------------------------------------------------
# K4: per emission slot tile keys and render fields
# ---------------------------------------------------------------------------


def expand_emission_plain(
    rr: torch.Tensor, table_g: torch.Tensor, n_slots: torch.Tensor, cap: int,
    tile_w: int, tiles_per_im: int, sentinel: int, packed: bool = False, tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (keys int32 [cap], fields f32 [F, cap], or the
    bf16-pair carriers [ceil(F/2), cap] with tile-local means when packed)."""
    R = rr.shape[1]
    dev = rr.device
    s = torch.arange(cap, dtype=torch.int32, device=dev)
    r = torch.searchsorted(rr[RR_IN].contiguous(), s, right=True)
    found = (s < n_slots) & (r < R)
    rc = torch.clamp(r, max=R - 1)
    rec = rr[:, rc]
    tx = rec[RR_X0] + (s - rec[RR_EX])
    key = rec[RR_IM] * tiles_per_im + rec[RR_TY] * tile_w + tx
    key = torch.where(found, torch.clamp(key, max=sentinel), sentinel).to(torch.int32)
    fields = table_g[:, rec[RR_GID].long()]
    fields = torch.where(found[None], fields, 0.0)
    if packed:
        origin = torch.where(found[None], torch.stack([tx, rec[RR_TY]]) * tile_size, 0)
        fields = pack_rows(torch.cat([fields[:2] - origin.to(torch.float32), fields[2:]]))
    return key, fields


def expand_emission(
    rr: torch.Tensor,  # [6, R] i32 row records (RR_* rows)
    table_g: torch.Tensor,  # [F, E] f32 render fields, zero for dummy gaussians
    n_slots: torch.Tensor,  # [1] i32 live emission slots
    cap: int,
    tile_w: int,
    tiles_per_im: int,
    sentinel: int,
    packed: bool = False,
    tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand row records to emission slots in gaussian-major order.

    Slot s belongs to record r with rr_cum_ex[r] <= s < rr_cum_in[r]; its
    key is im*tiles_per_im + ty*tile_w + x0 + (s - rr_cum_ex[r]) and it
    carries gaussian gid's fields.  Slots past n_slots get the sentinel key
    and zero fields.  Returns (keys int32 [cap], fields f32 [F, cap]).
    With `packed` the fields are the bf16-pair payload (ops/bf16pair.py):
    the mean made tile-local (x - tx*tile_size, y - ty*tile_size), then the
    F rows paired in order, [ceil(F/2), cap]; empty slots are zero bits.
    """
    _check_table("rr", rr, 6, torch.int32)
    if table_g.dim() != 2 or table_g.dtype != torch.float32 or not table_g.is_contiguous():
        raise ValueError("table_g must be a contiguous float32 [F, E] tensor")
    _check_count("n_slots", n_slots)
    if not check_kernel_device("expand_emission", rr, table_g, n_slots):
        return expand_emission_plain(rr, table_g, n_slots, cap, tile_w, tiles_per_im, sentinel,
                                     packed, tile_size)
    lib = _build.load("expand")
    F = table_g.shape[0]
    keys = torch.empty((cap,), dtype=torch.int32, device=rr.device)
    rows = -(-F // 2) if packed else F
    fields = torch.empty((rows, cap), dtype=torch.float32, device=rr.device)
    # the record of each 256-slot CTA's first slot, the search's brackets
    br = torch.empty((-(-cap // 256) + 1,), dtype=torch.int64, device=rr.device)
    code = lib.gs_expand_emission(
        rr.data_ptr(), rr.shape[1], table_g.data_ptr(), table_g.shape[1], F,
        n_slots.data_ptr(), cap, tile_w, tiles_per_im, sentinel, int(packed), tile_size,
        br.data_ptr(), br.shape[0], keys.data_ptr(), fields.data_ptr(), _build.stream_of(keys),
    )
    _build.check(lib, code, "expand_emission")
    if packed:
        expand_emission.launches_packed += 1
    else:
        expand_emission.launches += 1
    return keys, fields


expand_emission.launches = 0
expand_emission.launches_packed = 0


# ---------------------------------------------------------------------------
# K8: AABB emission (the 2DGS path)
# ---------------------------------------------------------------------------

# K8 rect rows rect [4, E]
RC_TMINX, RC_TMINY, RC_W, RC_IM = range(4)


def expand_emission_aabb_plain(
    cum_in: torch.Tensor, rect: torch.Tensor, depth: torch.Tensor,
    table: Optional[torch.Tensor], n_slots: torch.Tensor, cap: int, tile_w: int,
    tiles_per_im: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K8: (keys int32 [cap], depth f32 [cap], flat ids
    int32 [cap], fields f32 [R, cap], or None without a table)."""
    E = cum_in.shape[0]
    dev = cum_in.device
    s = torch.arange(cap, dtype=torch.int32, device=dev)
    g = torch.searchsorted(cum_in, s, right=True)
    found = (s < n_slots) & (g < E)
    gc = torch.clamp(g, max=E - 1)
    ex = torch.where(gc > 0, cum_in[torch.clamp(gc - 1, min=0)], 0)
    within = s - ex
    r = rect[:, gc]
    w_rect = torch.clamp(r[RC_W], min=1)
    ty = r[RC_TMINY] + torch.div(within, w_rect, rounding_mode="floor")
    tx = r[RC_TMINX] + torch.remainder(within, w_rect)
    key = torch.clamp(r[RC_IM] * tiles_per_im + ty * tile_w + tx, max=sentinel)
    key = torch.where(found, key, sentinel).to(torch.int32)
    live = key < sentinel
    del s, g, found, ex, within, r, w_rect, ty, tx  # a 4k step emits ~130 M slots
    depth_s = torch.where(live, depth[gc], float("inf"))
    flat = torch.where(live, gc, 0).to(torch.int32)
    if table is None:
        return key, depth_s, flat, None
    fields = table[:, gc].masked_fill_(~live[None], 0.0)  # by select: a NaN stays out
    return key, depth_s, flat, fields


def expand_emission_aabb(
    cum_in: torch.Tensor,  # [E] i32 inclusive cumsum of max(cnt, 1)
    rect: torch.Tensor,  # [4, E] i32 (tminx, tminy, w_rect, im); im == n_images: culled
    depth: torch.Tensor,  # [E] f32 sort depth
    table: Optional[torch.Tensor],  # [R, E] f32 render fields, or None
    n_slots: torch.Tensor,  # [1] i32 emission slots (dummies included)
    cap: int,
    tile_w: int,
    tiles_per_im: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Expand per-gaussian rows to AABB emission slots, gaussian-major.

    Gaussian g owns slots [cum_in[g-1], cum_in[g]) and covers its tile
    rectangle row by row.  A live slot gets its tile key
    im*tiles_per_im + ty*tile_w + tx, g's depth, g's flat id and g's fields;
    a slot at or past n_slots or a culled gaussian's dummy slot gets the
    sentinel key, depth inf, id 0 and zero fields.  Returns (keys int32
    [cap], depth f32 [cap], flat int32 [cap], fields f32 [R, cap]); without
    a table (the paths' mode: `gather_records` reads the fields through the
    sort) fields is None and nothing else changes.
    """
    if cum_in.dim() != 1 or cum_in.dtype != torch.int32 or not cum_in.is_contiguous():
        raise ValueError("cum_in must be a contiguous int32 [E] tensor")
    E = cum_in.shape[0]
    _check_table("rect", rect, 4, torch.int32)
    if rect.shape[1] != E or depth.shape != (E,) or depth.dtype != torch.float32:
        raise ValueError(f"rect and depth must cover the {E} gaussians of cum_in")
    if table is not None and (table.dim() != 2 or table.shape[1] != E
                              or table.dtype != torch.float32 or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous float32 [R, {E}] tensor")
    _check_count("n_slots", n_slots)
    tensors = (cum_in, rect, depth, n_slots) + (() if table is None else (table,))
    if not check_kernel_device("expand_emission_aabb", *tensors):
        return expand_emission_aabb_plain(cum_in, rect, depth, table, n_slots, cap, tile_w,
                                          tiles_per_im, sentinel)
    lib = _build.load("expand")
    R = 0 if table is None else table.shape[0]
    dev = cum_in.device
    keys = torch.empty((cap,), dtype=torch.int32, device=dev)
    depth_s = torch.empty((cap,), dtype=torch.float32, device=dev)
    flat = torch.empty((cap,), dtype=torch.int32, device=dev)
    fields = None if table is None else torch.empty((R, cap), dtype=torch.float32, device=dev)
    # the gaussian of each 256-slot CTA's first slot, the search's brackets
    br = torch.empty((-(-cap // 256) + 1,), dtype=torch.int64, device=dev)
    code = lib.gs_expand_aabb(
        cum_in.data_ptr(), rect.data_ptr(), E, depth.contiguous().data_ptr(),
        None if table is None else table.data_ptr(), R, n_slots.data_ptr(), cap, tile_w,
        tiles_per_im, sentinel, br.data_ptr(), br.shape[0], keys.data_ptr(),
        depth_s.data_ptr(), flat.data_ptr(), None if fields is None else fields.data_ptr(),
        _build.stream_of(keys),
    )
    _build.check(lib, code, "expand_emission_aabb")
    expand_emission_aabb.launches += 1
    return keys, depth_s, flat, fields


expand_emission_aabb.launches = 0


# ---------------------------------------------------------------------------
# K9: the gather into sorted order
# ---------------------------------------------------------------------------


def gather_records_plain(
    records: torch.Tensor, flat: torch.Tensor, order: torch.Tensor, n_live: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K9's record gather: records[flat[order]].t(), zero
    from the sorted position n_live on."""
    n = int(n_live)
    out = torch.zeros((records.shape[1], order.shape[0]), dtype=torch.float32,
                      device=records.device)
    out[:, :n] = records[flat[order[:n]].long()].t()
    return out


def gather_records(
    records: torch.Tensor,  # [E, R] f32 gaussian-major fields, rows at any stride >= R
    flat: torch.Tensor,  # [cap] i32 gaussian id of each emission slot (K8)
    order: torch.Tensor,  # [A] i64 emission slot at each sorted position (the sort's)
    n_live: torch.Tensor,  # [1] i32 sorted positions before the sentinel tail (bounds[T])
) -> torch.Tensor:
    """out[f, a] = records[flat[order[a]], f] for a < n_live, else 0:
    [R, A] f32, the same bits as the records.  This is K8's field copy
    followed by `align_rows` through `order`, without the emission-ordered
    table: a live sorted position holds a live slot, whose fields K8 copies
    from its gaussian's record, and the sentinel tail holds the slots K8
    zeroes.  A table whose row stride is a multiple of 4 floats (a padded
    record, `rasterize.gaussian_records`) is read in 16-byte loads."""
    if (records.dim() != 2 or records.dtype != torch.float32 or records.stride(1) != 1
            or records.stride(0) < records.shape[1]):
        raise ValueError("records must be a float32 [E, R] tensor with unit column stride")
    if flat.dim() != 1 or flat.dtype != torch.int32 or not flat.is_contiguous():
        raise ValueError(f"flat must be a contiguous int32 [cap] tensor, got {flat.dtype}")
    if order.dim() != 1 or order.dtype != torch.int64 or not order.is_contiguous():
        raise ValueError(f"order must be a contiguous int64 [A] tensor, got {order.dtype}")
    if n_live.shape != (1,) or n_live.dtype != torch.int32:
        raise ValueError(f"n_live must be an int32 [1] tensor, got {n_live.dtype} {tuple(n_live.shape)}")
    if not check_kernel_device("gather_records", records, flat, order, n_live):
        return gather_records_plain(records, flat, order, n_live)
    lib = _build.load("align")
    R = records.shape[1]
    out = torch.empty((R, order.shape[0]), dtype=torch.float32, device=records.device)
    code = lib.gs_gather_records(
        records.data_ptr(), records.stride(0), R, flat.data_ptr(), order.data_ptr(),
        n_live.contiguous().data_ptr(), order.shape[0], out.data_ptr(), _build.stream_of(out),
    )
    _build.check(lib, code, "gather_records")
    gather_records.launches += 1
    return out


gather_records.launches = 0


def align_rows_plain(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: rows[:, src], 0 where src < 0."""
    picked = rows[:, torch.clamp(src, min=0).long()]
    return torch.where(src[None] >= 0, picked, 0.0)


def align_rows(
    rows: torch.Tensor,  # [F, P] f32
    src: torch.Tensor,  # [A] i32 source column of each output column, -1 for padding
) -> torch.Tensor:
    """out[f, a] = rows[f, src[a]], and 0 where src[a] < 0: [F, A] f32, the
    same bits as the source."""
    if rows.dim() != 2 or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous float32 [F, P] tensor")
    if src.dim() != 1 or src.dtype != torch.int32 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous int32 [A] tensor, got {src.dtype} {tuple(src.shape)}")
    if not check_kernel_device("align_rows", rows, src):
        return align_rows_plain(rows, src)
    lib = _build.load("align")
    F, P = rows.shape
    A = src.shape[0]
    out = torch.empty((F, A), dtype=torch.float32, device=rows.device)
    code = lib.gs_align_rows(rows.data_ptr(), P, src.data_ptr(), A, F, out.data_ptr(),
                             _build.stream_of(out))
    _build.check(lib, code, "align_rows")
    align_rows.launches += 1
    return out


align_rows.launches = 0
