"""bf16-pair carriers: two float32 values rounded to bfloat16 and held in one
float32-typed word, the layout of the packed sort payload and of the packed
per-slot gradients.

Port of gsplat_tpu/ops/mxu.py:pack_bf16_pair / unpack_bf16_pair (:264-285)
and of the packed row layout of gsplat_tpu/ops/rasterize_pallas.py
(_unpack_chunk :229-245, packed_rows :248, grad_pack_rows :253).  A carrier's
bits are (bf16(hi) << 16) | bf16(lo); each half is rounded to nearest, ties
to even, as `Tensor.to(torch.bfloat16)` and CUDA's `__float2bfloat16_rn`
round (denormals kept, -0 kept, overflow to inf).  Zero bits unpack to
exact zeros.  (A NaN half comes out as some NaN; its payload bits are not
part of the contract.)

The packed payload of the 3DGS composite has packed_rows(D) carriers per
slot: (x_loc, y_loc) with the mean in tile-local pixels, (conic a, conic b),
(conic c, opacity), then the colours in pairs, an odd last one paired with
0.  That is the 6+D float32 rows paired in order, so one pairing serves the
payload and the per-slot gradients (grad_pack_rows(D) carriers of the 6+D
gradient rows) alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_HI_MASK = -65536  # 0xffff0000 as an int32: the carrier's high half


def packed_rows(n_channels: int) -> int:
    """Carriers of the packed payload: xy, (a, b), (c, op) and the colours."""
    return 3 + -(-n_channels // 2)


def grad_pack_rows(n_channels: int) -> int:
    """Carriers of the 6+D per-slot gradient rows."""
    return -(-(6 + n_channels) // 2)


def pack_bf16_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Round two float32 tensors of one shape to bfloat16 and pack each pair
    into one float32-typed carrier, (bf16(hi) << 16) | bf16(lo)."""
    pair = torch.stack([lo.to(torch.bfloat16), hi.to(torch.bfloat16)], dim=-1)
    return pair.view(torch.float32)[..., 0]  # little-endian: lo is the low half


def unpack_bf16_pair(carrier: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_bf16_pair`: (hi, lo) as float32, exactly the bf16
    values."""
    u = carrier.contiguous().view(torch.int32)
    return (u & _HI_MASK).view(torch.float32), (u << 16).view(torch.float32)


def pack_rows(rows: torch.Tensor) -> torch.Tensor:
    """[F, ...] float32 rows -> [ceil(F/2), ...] carriers of the rows paired
    in order, (0, 1), (2, 3), ...; an odd last row is paired with 0."""
    if rows.shape[0] % 2:
        rows = torch.cat([rows, torch.zeros_like(rows[:1])])
    return pack_bf16_pair(rows[0::2], rows[1::2])


def unpack_rows(carriers: torch.Tensor, n_rows: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of `pack_rows`: [R, ...] carriers -> the first `n_rows` of
    the 2R float32 rows, written into `out` (a contiguous float32 tensor of
    that shape) when given: one pass over the carriers, no temporaries."""
    if out is None:
        out = torch.empty((n_rows,) + carriers.shape[1:], dtype=torch.float32,
                          device=carriers.device)
    u = carriers.contiguous().view(torch.int32)
    o = out.view(torch.int32)
    torch.bitwise_and(u[: (n_rows + 1) // 2], _HI_MASK, out=o[0::2])  # rows 0, 2, ...: hi
    torch.bitwise_left_shift(u[: n_rows // 2], 16, out=o[1::2])  # rows 1, 3, ...: lo
    return out


def unpack_payload(rows: torch.Tensor, n_channels: int) -> torch.Tensor:
    """The packed payload [packed_rows(D), ...] -> the 6+D field rows (x_loc,
    y_loc, a, b, c, opacity, colours), as the packed composite reads them."""
    if rows.shape[0] != packed_rows(n_channels):
        raise ValueError(f"a packed payload of D={n_channels} has {packed_rows(n_channels)} "
                         f"rows, got {rows.shape[0]}")
    return unpack_rows(rows, 6 + n_channels)
