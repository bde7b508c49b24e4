"""Plain PyTorch reference of one 2DGS training step after densification
has stopped: render (surfel2d), loss, backward, selective Adam.

  * loss = (1 - ssim_lambda) L1 + ssim_lambda (1 - SSIM) of the colours
    clamped to [0, 1] (train3d.image_loss); from `normal_start` on, plus
    normal_lambda * mean(1 - n . n_d), n the rendered normals in the world
    frame and n_d the normals of the expected depth (depth sum over alpha,
    alpha clamped at 1e-10), held constant; from `dist_start` on, plus
    dist_lambda * the mean distortion;
  * selective Adam as train3d.  No strategy step changes a parameter here:
    refinement ends at 15,000 and the next opacity reset is at 18,000.

The gradient norms are taken over the visible rows, and again, as
`facing.<leaf>`, over those that are at least `facing_min_cos` from
edge-on (surfel2d.facing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import surfel2d
from .train3d import LEAVES, StepOut, grad_norms, image_loss, selective_adam


class Hyper(NamedTuple):
    lrs: dict
    max_steps: int
    ssim_lambda: float
    normal_lambda: float
    dist_lambda: float
    normal_start: int
    dist_start: int
    sh_degree: int
    render: dict
    width: int
    height: int
    facing_min_cos: float
    half_rows: bool = False


def outputs_loss(out: torch.Tensor, target, viewmat, K, step: int, hp: Hyper) -> torch.Tensor:
    """The loss of the per-pixel outputs [H, W, N_OUT]."""
    loss = image_loss(out[..., :3], target, hp.ssim_lambda, hp.half_rows)
    if step >= hp.normal_start:
        alpha = out[..., 7]
        depth = (out[..., 3] / torch.clamp(alpha, min=1e-10)).detach()
        nfd = surfel2d.depth_to_normal(depth, viewmat, K)
        R = viewmat[:3, :3]
        n_world = (R * out[..., 4:7, None]).sum(-2)  # R^T n
        loss = loss + hp.normal_lambda * (1.0 - (n_world * nfd).sum(-1)).mean()
    if step >= hp.dist_start:
        loss = loss + hp.dist_lambda * out[..., 8].mean()
    return loss


def train_step(params, mu, nu, alive, viewmat, K, target, step: int, hp: Hyper, noise=None,
               payload=None) -> StepOut:
    """One step in place on params, mu, nu (the rows given are the alive
    ones; `noise` is unused: the default strategy draws none here)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    v = surfel2d.view(leaves, viewmat, K, hp.width, hp.height, hp.render, hp.sh_degree)
    fields = v.fields.detach()
    out, _ = surfel2d.composite(fields, v.bins, hp.width, hp.height, payload)
    out = out.requires_grad_()
    loss = outputs_loss(out, target, viewmat, K, step, hp)
    loss.backward()
    v_fields = surfel2d.composite_backward(fields, v.bins, hp.width, hp.height, out.grad,
                                           payload)
    v.fields.backward(v_fields)
    vis = v.proj.visible & alive
    grads = {k: leaves[k].grad for k in LEAVES}
    norms = grad_norms(grads, vis)
    face = alive & surfel2d.facing(leaves["means"], v.proj, viewmat, hp.facing_min_cos)
    norms.update({f"facing.{k}": g for k, g in grad_norms(grads, face).items()})
    del leaves, v, fields, out
    selective_adam(params, grads, mu, nu, vis, hp.lrs, 0.01 ** (step / hp.max_steps))
    return StepOut(float(loss.detach()), norms)
