"""HexPlane regularisers (port of gsplat_tpu/contrib/dynamic/regulation.py).

plane_smoothness / time_smoothness: the mean squared second difference
along the H axis (time, for the temporal planes' reversed layout), summed
over planes.  time_l1: the L1 distance from the ones-initialisation, whose
|x| takes jnp.abs's derivative, +1 at x = 0 (torch.abs's is 0): the
temporal planes start at exactly 1, so the JAX regulariser's first
gradient there is -1/n of every entry, which Adam turns into a full step,
and the port's must be the same.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .hexplane import spatial_planes, temporal_planes


class _AbsJax(torch.autograd.Function):
    """|x| whose derivative is +1 where x >= 0 and -1 elsewhere (jnp.abs's)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _second_difference_squared(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    total = None
    for p in planes:
        if p.dim() not in (3, 4):
            raise ValueError(f"expected (C, H, W) planes, got shape {tuple(p.shape)}")
        if p.shape[-2] < 3:
            continue
        first = p[..., 1:, :] - p[..., :-1, :]
        second = first[..., 1:, :] - first[..., :-1, :]
        c = torch.mean(second ** 2)
        total = c if total is None else total + c
    return torch.zeros(()) if total is None else total


def plane_smoothness(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Spatial smoothness over the (xy, xz, yz) planes."""
    return _second_difference_squared(planes)


def time_smoothness(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Temporal smoothness over the (xt, yt, zt) planes (H axis = time)."""
    return _second_difference_squared(planes)


def time_l1(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """L1 distance from the ones-initialisation on the temporal planes."""
    total = None
    for p in planes:
        c = torch.mean(_AbsJax.apply(1.0 - p))
        total = c if total is None else total + c
    return torch.zeros(()) if total is None else total


def hexplane_regularization(
    field_params: Dict,
    lambda_plane_smooth: float = 1.0,
    lambda_time_smooth: float = 1.0,
    lambda_time_l1: float = 1.0,
) -> torch.Tensor:
    """The weighted sum of the three regularisers over a HexPlane dict."""
    sp = spatial_planes(field_params)
    tp = temporal_planes(field_params)
    return (lambda_plane_smooth * plane_smoothness(sp)
            + lambda_time_smooth * time_smoothness(tp)
            + lambda_time_l1 * time_l1(tp))
