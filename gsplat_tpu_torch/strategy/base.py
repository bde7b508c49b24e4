"""Strategy base contract.

Port of `gsplat_tpu/strategy/base.py`: the parameter dict and the Adam
moment dicts must share keys and shapes, so that a topology edit can treat
them alike.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


class Strategy:
    """Densification-strategy interface."""

    def check_sanity(self, params: Dict[str, torch.Tensor], opt_moments: Any) -> None:
        """Params and optimizer moments must share keys and shapes."""
        for moments in opt_moments if isinstance(opt_moments, tuple) else (opt_moments,):
            if set(moments) != set(params):
                raise ValueError(
                    f"params and optimizer moments must share keys, got {sorted(params)} "
                    f"vs {sorted(moments)}"
                )
            for k, p in params.items():
                if moments[k].shape != p.shape:
                    raise ValueError(f"moment {k!r} has shape {tuple(moments[k].shape)}, "
                                     f"the parameter {tuple(p.shape)}")

    def step_pre_backward(self, *args, **kwargs):
        """Hook before the gradient computation."""

    def step_post_backward(self, *args, **kwargs):
        """Hook after the update."""
