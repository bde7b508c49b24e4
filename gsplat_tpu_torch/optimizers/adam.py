"""Adam over a dict of gaussian parameter tensors.

Port of `gsplat_tpu/optimizers/adam.py`:
  * `adam_update`: standard Adam with bias correction and a learning rate
    per parameter;
  * `selective_adam_update`: the visibility-gated Adam of upstream gsplat's
    fused kernel.  Gaussians that were not visible this step keep their
    parameters and moments, and there is NO bias correction.

State layout: moment dicts keyed like the parameter dict, so the strategy
can zero per-gaussian moments with the indices it uses on the parameters.

Unlike the JAX functions, which return new arrays, both updates work IN
PLACE on the parameter and moment tensors (at 2.8 M gaussians with SH
degree 3 the parameters and their two moments are about 2 GB; a functional
update would hold them twice).  They return the same dict objects, so a
caller written for the functional form works unchanged.  Parameters are
plain tensors; the updates run without autograd.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Union

import torch

Lrs = Union[float, Mapping[str, float]]


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]  # first moments, keyed like the parameters
    nu: Dict[str, torch.Tensor]  # second moments
    count: torch.Tensor  # [] int32 steps taken (bias correction)


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=some.device),
    )


def _lr(lrs: Lrs, key: str) -> float:
    return lrs[key] if isinstance(lrs, Mapping) else lrs


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lrs: Lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """Standard Adam with bias correction, in place.  Returns (params, state)."""
    count = state.count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    for k, p in params.items():
        g, m, v = grads[k], state.mu[k], state.nu[k]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.sub_(_lr(lrs, k) * (m / c1) / (torch.sqrt(v / c2) + eps))
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


@torch.no_grad()
def selective_adam_update(params, grads, state: AdamState, lrs: Lrs,
                          visibility: Optional[torch.Tensor] = None,  # [N] bool
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Visibility-gated Adam without bias correction, in place.

    Gaussians with visibility == False keep their parameters and moments
    untouched.  Returns (params, state).
    """
    for k, p in params.items():
        g, m, v = grads[k], state.mu[k], state.nu[k]
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        p_new = p - _lr(lrs, k) * m_new / (torch.sqrt(v_new) + eps)
        if visibility is None:
            p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)
        else:
            vis = visibility.reshape(visibility.shape + (1,) * (p.dim() - visibility.dim()))
            p.copy_(torch.where(vis, p_new, p))
            m.copy_(torch.where(vis, m_new, m))
            v.copy_(torch.where(vis, v_new, v))
    return params, AdamState(mu=state.mu, nu=state.nu, count=state.count + 1)
