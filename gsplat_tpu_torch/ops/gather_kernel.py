"""Tight-plan row expansion (K3) and emission expansion (K4).

Wrappers for `csrc/expand.cu`, each with its plain PyTorch version.  On a
CUDA tensor a wrapper launches its kernel (or raises); the plain version
runs only for CPU tensors.  Each wrapper counts its launches in
`<wrapper>.launches`.

K3 `expand_rows` replaces gsplat_tpu/ops/gather_pallas.py:_expand_rows_kernel
(:396, wrapper :526); K4 `expand_emission` replaces
gather_pallas.py:_expand2_kernel (:584, wrapper expand_emission2 :721),
unpacked layout.  The TPU kernels' windowed one-hot selection and hi/lo
integer transport are TPU workarounds and are not ported: the CUDA kernels
find their source row by binary search and read it directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .._device import check_kernel_device

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
    code = lib.gs_expand_rows(
        gg_f.data_ptr(), gg_i.data_ptr(), gg_f.shape[1], n_rows.data_ptr(),
        row_cap, float(tile_size), n_images, out.data_ptr(), _build.stream_of(out),
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
    tile_w: int, tiles_per_im: int, sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (keys int32 [cap], fields f32 [F, cap])."""
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
    return key, fields


def expand_emission(
    rr: torch.Tensor,  # [6, R] i32 row records (RR_* rows)
    table_g: torch.Tensor,  # [F, E] f32 render fields, zero for dummy gaussians
    n_slots: torch.Tensor,  # [1] i32 live emission slots
    cap: int,
    tile_w: int,
    tiles_per_im: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand row records to emission slots in gaussian-major order.

    Slot s belongs to record r with rr_cum_ex[r] <= s < rr_cum_in[r]; its
    key is im*tiles_per_im + ty*tile_w + x0 + (s - rr_cum_ex[r]) and it
    carries gaussian gid's fields.  Slots past n_slots get the sentinel key
    and zero fields.  Returns (keys int32 [cap], fields f32 [F, cap]).
    """
    _check_table("rr", rr, 6, torch.int32)
    if table_g.dim() != 2 or table_g.dtype != torch.float32 or not table_g.is_contiguous():
        raise ValueError("table_g must be a contiguous float32 [F, E] tensor")
    _check_count("n_slots", n_slots)
    if not check_kernel_device("expand_emission", rr, table_g, n_slots):
        return expand_emission_plain(rr, table_g, n_slots, cap, tile_w, tiles_per_im, sentinel)
    lib = _build.load("expand")
    F = table_g.shape[0]
    keys = torch.empty((cap,), dtype=torch.int32, device=rr.device)
    fields = torch.empty((F, cap), dtype=torch.float32, device=rr.device)
    code = lib.gs_expand_emission(
        rr.data_ptr(), rr.shape[1], table_g.data_ptr(), table_g.shape[1], F,
        n_slots.data_ptr(), cap, tile_w, tiles_per_im, sentinel,
        keys.data_ptr(), fields.data_ptr(), _build.stream_of(keys),
    )
    _build.check(lib, code, "expand_emission")
    expand_emission.launches += 1
    return keys, fields


expand_emission.launches = 0
