"""A PLAS-style self-organising 2-D grid sort.

Port of `gsplat_tpu/compression/plas.py:36-168` (after the reference's PLAS
dependency, fraunhoferhhi/PLAS): arrange attribute vectors on a 2-D grid so
that neighbouring cells hold similar vectors, which PNG's row predictors
then code as small residuals.  Coarse-to-fine annealed pair swaps against a
blurred target field:

  for scale in [S/2, S/4, ..., 1]:
    repeat a few times:
      target = box-blur(grid, radius ~ scale)
      pair cells at offset `scale` along each axis, with each parity, in an
      order shuffled by numpy's default_rng(seed)
      swap each pair iff that lowers sum |cell - target|^2

A swap against a blurred target is the 2-cell linear assignment problem
that PLAS solves in blocks.  The sweeps are elementwise work and sums on
the device the caller names (the card by default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def _blur(grid: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box blur of [S, S, F] with the edges clamped (a box of
    2r + 1 cells, r = max(radius, 1)), by cumulative sums along each axis."""
    S = grid.shape[0]
    r = max(int(radius), 1)

    def box1d(x: torch.Tensor, axis: int) -> torch.Tensor:
        lo_pad = x.narrow(axis, 0, 1).repeat_interleave(r, dim=axis)
        hi_pad = x.narrow(axis, S - 1, 1).repeat_interleave(r, dim=axis)
        cs = torch.cumsum(torch.cat([lo_pad, x, hi_pad], dim=axis), dim=axis)
        cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
        return (cs.narrow(axis, 2 * r + 1, S) - cs.narrow(axis, 0, S)) / (2 * r + 1)

    return box1d(box1d(grid, 0), 1)


def _sweep(grid: torch.Tensor, idx: torch.Tensor, parity: int, offset: int, axis: int,
           radius: int):
    """One sweep of pair swaps at `offset` along `axis`, the pairs anchored
    at parity * offset."""
    target = _blur(grid, radius)
    S = grid.shape[0]
    coord = torch.arange(S, device=grid.device)
    k = (coord + parity * offset) // offset
    partner = torch.where(k % 2 == 0, coord + offset, coord - offset)
    valid = (partner >= 0) & (partner < S)
    partner = torch.clamp(partner, 0, S - 1)
    g_par = grid.index_select(axis, partner)
    i_par = idx.index_select(axis, partner)
    t_par = target.index_select(axis, partner)
    d_now = torch.sum((grid - target) ** 2, dim=-1) + torch.sum((g_par - t_par) ** 2, dim=-1)
    d_swp = torch.sum((g_par - target) ** 2, dim=-1) + torch.sum((grid - t_par) ** 2, dim=-1)
    do = (d_swp < d_now) & valid.reshape((S, 1) if axis == 0 else (1, S))
    return torch.where(do[..., None], g_par, grid), torch.where(do, i_par, idx)


def plas_sort_indices(params: np.ndarray, n_sidelen: int, iters_per_scale: int = 8,
                      seed: int = 0, normalize: bool = True,
                      init_order: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """A permutation of [0, N) (N = n_sidelen^2) that arranges the rows of
    `params` [N, F] on an organised grid: grid position -> source row, to be
    applied as params[perm].  `normalize` min-max scales each attribute
    first; `init_order` is a permutation to start from.  The sweeps run on
    `device`, the card unless the caller names another."""
    dev = resolve_device(device)
    N, F = params.shape
    S = n_sidelen
    if N != S * S:
        raise ValueError(f"{N} rows do not fill a {S}x{S} grid")
    p = params.astype(np.float32)
    if normalize:
        mins = p.min(axis=0)
        maxs = p.max(axis=0)
        p = (p - mins) / np.where(maxs - mins == 0, 1, maxs - mins)
    base = (np.arange(N, dtype=np.int32) if init_order is None
            else np.asarray(init_order, np.int32))
    grid = torch.from_numpy(np.ascontiguousarray(p[base].reshape(S, S, F))).to(dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev).reshape(S, S)
    rng = np.random.default_rng(seed)
    scale = S // 2
    while scale >= 1:
        radius = max(scale // 2, 1)
        # every (axis, parity) pairing each round, in a shuffled order
        for _ in range(max(iters_per_scale // 4, 1)):
            pairings = [(a, q) for a in (0, 1) for q in (0, 1)]
            rng.shuffle(pairings)
            for axis, parity in pairings:
                grid, idx = _sweep(grid, idx, parity, scale, axis, radius)
        scale //= 2
    return base[idx.reshape(-1).cpu().numpy()]
