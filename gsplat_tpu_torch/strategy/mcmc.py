"""MCMC densification strategy (3DGS as Markov Chain Monte Carlo).

Port of `gsplat_tpu/strategy/mcmc.py`: relocate dead gaussians (opacity <=
min_opacity) onto opacity-sampled live ones with the Eq. 9 correction, grow
5% per refine up to cap_max, and inject covariance-shaped noise scaled by
lr * noise_lr every step.  The parameter tensors are allocated at `cap_max`
once and only the `alive` mask changes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from . import ops
from .base import Strategy
from .ops import DEFAULT_MCMC_OPACITY_K, DEFAULT_MCMC_OPACITY_T


@dataclasses.dataclass(frozen=True)
class MCMCStrategy(Strategy):
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    noise_injection_stop_iter: int = -1
    refine_every: int = 100
    min_opacity: float = 0.005
    noise_opacity_t: float = DEFAULT_MCMC_OPACITY_T
    noise_opacity_k: float = DEFAULT_MCMC_OPACITY_K

    def initialize_state(self, device=None) -> Dict[str, Any]:
        return {"binoms": ops.make_binoms(51, device=device)}

    def should_refine(self, step: int) -> bool:
        return (self.refine_start_iter < step < self.refine_stop_iter
                and step % self.refine_every == 0)

    def should_inject_noise(self, step: int) -> bool:
        stop = (self.noise_injection_stop_iter if self.noise_injection_stop_iter >= 0
                else float("inf"))
        return step < stop

    @torch.no_grad()
    def refine(self, params, opt_moments, alive, state,
               generator: Optional[torch.Generator] = None,
               u_relocate: Optional[torch.Tensor] = None,
               u_add: Optional[torch.Tensor] = None):
        """Relocate dead gaussians, then grow 5% toward cap_max.  Updates
        `params` and the moments in place; returns (params, moments, alive)."""
        binoms = state["binoms"]
        dead = alive & (torch.sigmoid(params["opacities"]) <= self.min_opacity)
        params, opt_moments, alive = ops.relocate(
            params, opt_moments, alive, dead, binoms, generator,
            min_opacity=self.min_opacity, u=u_relocate,
        )
        current = int(alive.sum())
        # 1.05 * current in float32, truncated, as the JAX package computes it
        n_target = min(self.cap_max, int(torch.tensor(1.05, dtype=torch.float32)
                                         * torch.tensor(current, dtype=torch.float32)))
        params, opt_moments, alive = ops.sample_add(
            params, opt_moments, alive, max(0, n_target - current), binoms, generator,
            min_opacity=self.min_opacity, u=u_add,
        )
        return params, opt_moments, alive

    @torch.no_grad()
    def inject_noise(self, params, alive, lr_means: float,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None):
        """Noise step, scaled by the current means learning rate; in place."""
        return ops.inject_noise_to_position(
            params, alive, lr_means * self.noise_lr, generator,
            t=self.noise_opacity_t, k=self.noise_opacity_k, noise=noise,
        )
