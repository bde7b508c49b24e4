"""Topology operations on capacity-padded gaussian parameter dicts.

Port of `gsplat_tpu/strategy/ops.py` (the default strategy's _ranked_pairs,
duplicate, split, remove and reset_opa :47-198; MCMC's relocation, sampling
and noise :201-396).  Every tensor has a static capacity and an `alive`
mask: "adding" gaussians writes into free slots and "removing" clears mask
bits.  Slots that receive new gaussians get zeroed Adam moments.

Where the JAX functions pad index lists to the capacity with out-of-range
entries that its scatters drop, these build the exact index lists (boolean
masks and `nonzero`, which returns indices in ascending order as
`jnp.nonzero` does), so nothing needs dropping.

The functions update `params` and the moment dicts IN PLACE and return them;
`alive` is returned as a new tensor.  Each stochastic function draws from a
`torch.Generator`, or takes the samples themselves (`u` / `noise`), which is
how the tests feed it the JAX package's numbers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.math import quat_to_rotmat

DEFAULT_MCMC_OPACITY_T = 0.005
DEFAULT_MCMC_OPACITY_K = 100.0
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _dicts(tree: Any):
    """The parameter-shaped dicts inside `tree` (a dict or a tuple of dicts)."""
    return tree if isinstance(tree, (tuple, list)) else (tree,)


def _tree_write(params: Dict[str, torch.Tensor], dst: torch.Tensor, src: torch.Tensor):
    """params[dst] = params[src] for every tensor.  `dst` must hold distinct
    rows (it always lists free or dead slots), so no write order matters."""
    if dst.numel() != torch.unique(dst).numel():
        raise ValueError("_tree_write: duplicate destination rows")
    for p in params.values():
        p[dst] = p[src]
    return params


def _tree_zero_at(tree: Any, idx: torch.Tensor):
    """tensor[idx] = 0 for every tensor of every dict in `tree`."""
    for d in _dicts(tree):
        for v in d.values():
            v[idx] = 0
    return tree


def _ranked_pairs(mask: torch.Tensor, free: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair the k-th masked slot with the k-th free slot, for as many as both
    have: returns (dst, src), params[dst[k]] to be written from src[k]."""
    src = torch.nonzero(mask)[:, 0]
    dst = torch.nonzero(free)[:, 0]
    n = min(src.numel(), dst.numel())
    return dst[:n], src[:n]


@torch.no_grad()
def duplicate(
    params: Dict[str, torch.Tensor],
    opt_moments: Any,  # dict(s) shaped like params, e.g. (mu, nu)
    alive: torch.Tensor,  # [cap] bool
    mask: torch.Tensor,  # [cap] bool gaussians to duplicate
    extra: Optional[Dict[str, torch.Tensor]] = None,  # per-gaussian sidecar rows
):
    """Copy masked gaussians into free slots, which get zeroed moments;
    `extra` rows are copied parent to child.  Returns (params, moments,
    alive) and, with `extra`, the sidecar dict too."""
    dst, src = _ranked_pairs(mask & alive, ~alive)
    _tree_write(params, dst, src)
    _tree_zero_at(opt_moments, dst)
    alive = alive.clone()
    alive[dst] = True
    if extra is not None:
        return params, opt_moments, alive, _tree_write(extra, dst, src)
    return params, opt_moments, alive


@torch.no_grad()
def split(
    params: Dict[str, torch.Tensor],
    opt_moments: Any,
    alive: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    revised_opacity: bool = False,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    sample_axes: Tuple[int, ...] = (0, 1, 2),
    noise: Optional[torch.Tensor] = None,  # [2, cap, 3] standard normal samples
):
    """Split each masked gaussian in two: both samples drawn from it (mean +
    R S n), scales shrunk by 1.6, the first in its own slot and the second in
    a free slot, both with zeroed moments.  `sample_axes` restricts the
    sampling to those local axes (a surfel's normal-axis scale gets no render
    gradient, so the 2DGS trainer passes (0, 1)).  The noise is drawn as the
    JAX package draws it, [2, cap, 3], unless given."""
    cap = alive.shape[0]
    mask = mask & alive
    dst, src = _ranked_pairs(mask, ~alive)
    means = params["means"]
    scales = torch.exp(params["scales"])
    if tuple(sample_axes) != (0, 1, 2):
        axes = torch.tensor([1.0 if i in tuple(sample_axes) else 0.0 for i in range(3)],
                            dtype=scales.dtype, device=scales.device)
        scales = scales * axes
    if noise is None:
        noise = torch.randn((2, cap, 3), generator=generator, device=means.device,
                            dtype=means.dtype)
    R = quat_to_rotmat(params["quats"])  # [cap, 3, 3]
    samples = (R[None] * (scales[None] * noise)[:, :, None, :]).sum(dim=-1)  # [2, cap, 3]

    sel = torch.nonzero(mask)[:, 0]
    child_means = means[src] + samples[1][src]
    if revised_opacity:
        o = torch.sigmoid(params["opacities"][sel])
        new_op = torch.logit(torch.clamp(1.0 - torch.sqrt(1.0 - o), 1e-7, 1.0 - 1e-7))
        params["opacities"][sel] = new_op
    means[sel] = means[sel] + samples[0][sel]
    params["scales"][sel] = params["scales"][sel] - math.log(1.6)
    _tree_write(params, dst, src)
    means[dst] = child_means
    _tree_zero_at(opt_moments, sel)
    _tree_zero_at(opt_moments, dst)
    alive = alive.clone()
    alive[dst] = True
    if extra is not None:
        return params, opt_moments, alive, _tree_write(extra, dst, src)
    return params, opt_moments, alive


def remove(alive: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Deactivate masked gaussians; their slots are rewritten when reused."""
    return alive & ~mask


@torch.no_grad()
def reset_opa(params: Dict[str, torch.Tensor], opt_moments: Any, value: float):
    """Clamp opacities to at most logit(value) and zero their moments, in
    place."""
    params["opacities"].clamp_(max=math.log(value / (1.0 - value)))
    for d in _dicts(opt_moments):
        d["opacities"].zero_()
    return params, opt_moments


def make_binoms(n_max: int = 51, device=None) -> torch.Tensor:
    """Binomial coefficient table C(n, k), float32 [n_max, n_max]."""
    b = torch.zeros((n_max, n_max), dtype=torch.float32)
    for n in range(n_max):
        for k in range(n + 1):
            b[n, k] = math.comb(n, k)
    return b.to(device) if device is not None else b


def compute_relocation(
    opacities: torch.Tensor,  # [cap] post-sigmoid
    scales: torch.Tensor,  # [cap, 3] post-exp
    ratios: torch.Tensor,  # [cap] integer sample multiplicities, >= 1
    binoms: torch.Tensor,  # [n_max, n_max]
    min_opacity: float = 0.005,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MCMC relocation (Eq. 9 of arXiv:2404.09591), with the clamp before
    the scale as upstream's kernel has it.  The double sum collapses via the
    hockey-stick identity: denom(n) = sum_k C(n, k+1) (-1)^k / sqrt(k+1)
    o'^(k+1)."""
    n_max = binoms.shape[0]
    dev = opacities.device
    n = torch.clamp(ratios, 1, n_max).long()
    new_op = 1.0 - torch.pow(1.0 - opacities, 1.0 / n.to(opacities.dtype))
    new_op = torch.clamp(new_op, min_opacity, 1.0 - _F32_EPS)

    ks = torch.arange(n_max, dtype=torch.float32, device=dev)
    sign = torch.where(torch.arange(n_max, device=dev) % 2 == 0, 1.0, -1.0)
    term = sign / torch.sqrt(ks + 1.0) * torch.pow(new_op[:, None], ks[None, :] + 1.0)
    cnk = binoms[torch.clamp(n, max=n_max - 1)]  # [cap, n_max]
    cnk1 = torch.cat([cnk[:, 1:], torch.zeros_like(cnk[:, :1])], dim=1)  # C(n, k+1)
    kmask = ks[None, :] < n[:, None].to(torch.float32)
    denom = torch.where(kmask, cnk1 * term, 0.0).sum(dim=1)
    coeff = opacities / torch.where(denom == 0, 1.0, denom)
    return new_op, coeff[:, None] * scales


def _sample_alive(
    opacities: torch.Tensor,  # [cap] post-sigmoid
    alive: torch.Tensor,  # [cap] bool
    n_draws: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,  # [n_draws] uniform samples in [0, 1)
) -> torch.Tensor:
    """Multinomial sample (with replacement) of alive slots by opacity, by
    inverse-CDF sampling."""
    w = torch.where(alive, torch.clamp(opacities, min=1e-12), 0.0)
    cum = torch.cumsum(w, dim=0)
    if u is None:
        u = torch.rand(n_draws, generator=generator, device=opacities.device)
    idx = torch.searchsorted(cum, u.to(cum.dtype) * cum[-1], right=True)
    return torch.clamp(idx, 0, w.shape[0] - 1)


def _relocate_onto(params, opt_moments, sampled, dst, binoms, min_opacity):
    """Shared tail of relocate and sample_add: the sampled sources take the
    Eq. 9 opacity and scale for their multiplicity, the destination slots
    copy the updated sources, and both lose their Adam moments."""
    cap = params["opacities"].shape[0]
    op = torch.sigmoid(params["opacities"])
    ratios = torch.bincount(sampled, minlength=cap) + 1  # duplicates count
    new_op, new_scales = compute_relocation(op, torch.exp(params["scales"]), ratios, binoms,
                                            min_opacity)
    touched = torch.unique(sampled)
    params["opacities"][touched] = torch.logit(new_op[touched])
    params["scales"][touched] = torch.log(new_scales[touched])
    _tree_write(params, dst, sampled)
    _tree_zero_at(opt_moments, touched)
    # upstream zeroes only the sampled sources' moments; like the JAX package
    # this zeroes the destination slots' too
    _tree_zero_at(opt_moments, dst)


@torch.no_grad()
def relocate(
    params: Dict[str, torch.Tensor],
    opt_moments: Any,
    alive: torch.Tensor,
    dead_mask: torch.Tensor,  # [cap] bool (subset of alive)
    binoms: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    min_opacity: float = 0.005,
    u: Optional[torch.Tensor] = None,  # [cap] uniform samples
):
    """Teleport dead gaussians onto opacity-sampled live ones: sample with
    replacement by opacity, apply `compute_relocation` to the sampled
    sources, copy the updated source into each dead slot."""
    cap = alive.shape[0]
    dead_mask = dead_mask & alive
    live = alive & ~dead_mask
    draws = _sample_alive(torch.sigmoid(params["opacities"]), live, cap, generator, u)
    dst = torch.nonzero(dead_mask)[:, 0]
    if dst.numel():
        _relocate_onto(params, opt_moments, draws[: dst.numel()], dst, binoms, min_opacity)
    return params, opt_moments, alive


@torch.no_grad()
def sample_add(
    params: Dict[str, torch.Tensor],
    opt_moments: Any,
    alive: torch.Tensor,
    n_add: int,  # how many to add (clamped by the free slots)
    binoms: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    min_opacity: float = 0.005,
    u: Optional[torch.Tensor] = None,  # [cap] uniform samples
):
    """Add new gaussians sampled from live ones (MCMC grow): the relocation
    math updates the sampled sources and the new slots copy them."""
    cap = alive.shape[0]
    draws = _sample_alive(torch.sigmoid(params["opacities"]), alive, cap, generator, u)
    free = torch.nonzero(~alive)[:, 0]
    n = min(int(n_add), free.numel())
    if n > 0:
        dst = free[:n]
        _relocate_onto(params, opt_moments, draws[:n], dst, binoms, min_opacity)
        alive = alive.clone()
        alive[dst] = True
    return params, opt_moments, alive


@torch.no_grad()
def inject_noise_to_position(
    params: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    noise_scale: float,
    generator: Optional[torch.Generator] = None,
    t: float = DEFAULT_MCMC_OPACITY_T,
    k: float = DEFAULT_MCMC_OPACITY_K,
    noise: Optional[torch.Tensor] = None,  # [cap, 3] standard normal samples
):
    """Covariance-shaped, opacity-gated positional noise (MCMC explore):
    means += Sigma @ (randn * sigmoid(-k (o - t)) * noise_scale) on alive
    gaussians.  The 3x3 products are written elementwise (full float32)."""
    means = params["means"]
    op = torch.sigmoid(params["opacities"])
    M = quat_to_rotmat(params["quats"]) * torch.exp(params["scales"])[..., None, :]
    if noise is None:
        noise = torch.randn(means.shape, generator=generator, device=means.device,
                            dtype=means.dtype)
    n = noise * (torch.sigmoid(-k * (op - t)) * noise_scale)[:, None]
    mtn = (M * n[:, :, None]).sum(dim=1)  # M^T n
    delta = (M * mtn[:, None, :]).sum(dim=2)  # M M^T n
    means.add_(torch.where(alive[:, None], delta, 0.0))
    return params
