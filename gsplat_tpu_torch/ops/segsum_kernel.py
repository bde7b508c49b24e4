"""Segmented row sum (K5): wrapper for `csrc/segsum.cu`.

Replaces gsplat_tpu/ops/segsum_pallas.py:_segsum_kernel (:38, wrapper
segment_rowsum :126).  On a CUDA tensor the wrapper launches the kernel (or
raises); the plain version runs only for CPU tensors.  Launches are counted
in `segment_rowsum.launches`.
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import check_kernel_device


def segment_rowsum_plain(data: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Plain version of K5.  Rounds of one add each: round j adds every
    segment's j-th element, so each segment is summed serially in slot
    order, as the kernel sums it, in float32."""
    F = data.shape[0]
    E = bounds.shape[0] - 1
    out = torch.zeros((F, E), dtype=torch.float32, device=data.device)
    if E == 0 or data.shape[1] == 0:
        return out
    lo = bounds[:-1].long()
    length = bounds[1:].long() - lo
    open_ = torch.nonzero(length > 0)[:, 0]
    j = 0
    while open_.numel():
        out[:, open_] += data[:, lo[open_] + j]
        j += 1
        open_ = open_[length[open_] > j]
    return out


def segment_rowsum(
    data: torch.Tensor,  # [F, P] f32, slots grouped by segment
    bounds: torch.Tensor,  # [E+1] i32 monotone slot boundaries, within [0, P]
) -> torch.Tensor:
    """out[:, g] = sum of data[:, bounds[g]:bounds[g+1]], float32 [F, E],
    each segment added in slot order.  Elements at or past bounds[-1] are
    never read."""
    if data.dim() != 2 or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("data must be a contiguous float32 [F, P] tensor")
    if bounds.dim() != 1 or bounds.shape[0] < 1 or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32 [E+1], got {bounds.dtype} {tuple(bounds.shape)}")
    if not check_kernel_device("segment_rowsum", data, bounds):
        return segment_rowsum_plain(data, bounds)
    lib = _build.load("segsum")
    F, P = data.shape
    E = bounds.shape[0] - 1
    out = torch.empty((F, E), dtype=torch.float32, device=data.device)
    code = lib.gs_segment_rowsum(
        data.data_ptr(), P, F, bounds.contiguous().data_ptr(), E, out.data_ptr(),
        _build.stream_of(out),
    )
    _build.check(lib, code, "segment_rowsum")
    segment_rowsum.launches += 1
    return out


segment_rowsum.launches = 0
