"""Default (ADC) densification strategy: the original 3DGS recipe and AbsGS.

Port of `gsplat_tpu/strategy/default.py`: accumulate per-gaussian
screen-gradient norms, duplicate small high-gradient gaussians, split large
ones, prune transparent or oversized ones, and reset opacities now and then.
Parameters live in capacity-padded tensors with an `alive` mask, so growth
writes into free slots.  Screen gradients arrive as the gradient of the
render's carrier ([C, cap, 2]: `means2d_offset` of rasterization(), or
`densify` of rasterization_2dgs()).  `scene_scale` is a float inside the
state dict; the other state entries are tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import ops
from .base import Strategy


@dataclasses.dataclass(frozen=True)
class DefaultStrategy(Strategy):
    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    refine_scale2d_stop_iter: int = 0
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    absgrad: bool = False
    revised_opacity: bool = False
    # state entries holding per-gaussian rows that follow topology edits
    # (children inherit their parent's row)
    sidecar_state_keys: Tuple[str, ...] = ()
    # local scale axes of the scale tests and the split sampling; surfels pass
    # (0, 1), since their normal-axis scale gets no render gradient
    scale_axes: Tuple[int, ...] = (0, 1, 2)

    def initialize_state(self, cap: int, scene_scale: float = 1.0,
                         device=None) -> Dict[str, Any]:
        state = {
            "grad2d": torch.zeros(cap, dtype=torch.float32, device=device),
            "count": torch.zeros(cap, dtype=torch.float32, device=device),
            "scene_scale": float(scene_scale),
        }
        if self.refine_scale2d_stop_iter > 0:
            state["radii"] = torch.zeros(cap, dtype=torch.float32, device=device)
        return state

    def should_refine(self, step: int) -> bool:
        return (self.refine_start_iter < step < self.refine_stop_iter
                and step % self.refine_every == 0
                and step % self.reset_every >= self.pause_refine_after_reset)

    def should_reset_opa(self, step: int) -> bool:
        return step % self.reset_every == 0 and step > 0

    @torch.no_grad()
    def update_state(self, state: Dict[str, Any], screen_grads: torch.Tensor,
                     radii: torch.Tensor, width: int, height: int,
                     n_cameras: int) -> Dict[str, Any]:
        """Accumulate gradient norms in pixel units times the camera count,
        and visibility counts, over gaussians with radii > 0; in place."""
        scale = torch.tensor([width / 2.0 * n_cameras, height / 2.0 * n_cameras],
                             dtype=screen_grads.dtype, device=screen_grads.device)
        sel = (radii > 0).all(dim=-1)  # [C, cap]
        norms = torch.linalg.vector_norm(screen_grads * scale, dim=-1) * sel
        state["grad2d"] += norms.sum(dim=0)
        state["count"] += sel.sum(dim=0).to(torch.float32)
        if "radii" in state:
            r = (radii.amax(dim=-1) * sel).amax(dim=0).to(torch.float32)
            torch.maximum(state["radii"], r / float(max(width, height)), out=state["radii"])
        return state

    @torch.no_grad()
    def refine(self, params: Dict[str, torch.Tensor], opt_moments: Any, alive: torch.Tensor,
               state: Dict[str, Any], step: int, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """Grow (duplicate, then split) and prune; then clear the running
        statistics.  Updates params, moments and state in place; returns
        (params, moments, alive, state).  `noise` ([2, cap, 3]) replaces the
        split's draws from `generator`."""
        ax = list(self.scale_axes)
        grads = state["grad2d"] / torch.clamp(state["count"], min=1.0)
        is_grad_high = (grads > self.grow_grad2d) & alive
        scale_max = torch.exp(params["scales"][..., ax]).amax(dim=-1)
        is_small = scale_max <= self.grow_scale3d * state["scene_scale"]
        is_dupli = is_grad_high & is_small
        is_split = is_grad_high & ~is_small
        if step < self.refine_scale2d_stop_iter and "radii" in state:
            is_split |= (state["radii"] > self.grow_scale2d) & alive

        sidecar = {k: state[k] for k in self.sidecar_state_keys if k in state}
        extra = sidecar or None
        out = ops.duplicate(params, opt_moments, alive, is_dupli, extra=extra)
        params, opt_moments, alive = out[:3]
        # gaussians added by duplication are not split
        out = ops.split(params, opt_moments, alive, is_split, generator,
                        revised_opacity=self.revised_opacity, extra=extra,
                        sample_axes=self.scale_axes, noise=noise)
        params, opt_moments, alive = out[:3]

        # prune, with the scales of the grown set
        scale_max = torch.exp(params["scales"][..., ax]).amax(dim=-1)
        is_prune = (torch.sigmoid(params["opacities"]) < self.prune_opa) & alive
        if step > self.reset_every:
            is_too_big = scale_max > self.prune_scale3d * state["scene_scale"]
            if step < self.refine_scale2d_stop_iter and "radii" in state:
                is_too_big |= state["radii"] > self.prune_scale2d
            is_prune |= is_too_big & alive
        alive = ops.remove(alive, is_prune)

        state["grad2d"].zero_()
        state["count"].zero_()
        if "radii" in state:
            state["radii"].zero_()
        return params, opt_moments, alive, state

    def reset_opa(self, params: Dict[str, torch.Tensor], opt_moments: Any):
        """Opacities down to at most twice the prune threshold; in place."""
        return ops.reset_opa(params, opt_moments, self.prune_opa * 2.0)
