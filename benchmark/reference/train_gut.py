"""Plain PyTorch reference of one 3DGUT training step with the MCMC strategy
between refinements: render through the distorting camera (gut3d), loss,
backward, selective Adam and the MCMC positional noise, as upstream gsplat's
`simple_trainer.py mcmc --with_ut --with_eval3d` steps.

  * loss = (1 - ssim_lambda) L1 + ssim_lambda (1 - SSIM) of the render
    clamped to [0, 1] (train3d.image_loss), plus opacity_reg *
    mean(sigmoid(opacity)) and scale_reg * mean(exp(scales)) over the alive
    rows (dead rows count as 0);
  * the gradients by autograd: the composite's gradient with respect to the
    visible rows' fields (x, M = diag(1/s) R^T, opacity, colour), then
    through M to quats and scales, through x and the SH view direction to
    the means; the unscented projection only tiles and sorts, so no
    gradient passes through it;
  * selective Adam (train3d.selective_adam) on the rows the projection
    keeps, the means' rate scaled by 0.01^(step / max_steps) and by the
    scene scale;
  * then means += Sigma (n sigmoid(-k (opacity - t)) noise_lr lr_means) on
    alive rows, n standard normal [cap, 3], Sigma = (R S)(R S)^T of the
    updated parameters (Kheradmand et al. 2024).  `noise` draws n.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from . import gut3d
from .splat3d import quat_to_rotmat
from .train3d import LEAVES, StepOut, grad_norms, image_loss, selective_adam


class Hyper(NamedTuple):
    """The step's settings, as the configuration states them."""
    lrs: Dict[str, float]  # base rates, the means' already times the scene scale
    max_steps: int
    ssim_lambda: float
    opacity_reg: float
    scale_reg: float
    noise_lr: float
    noise_t: float
    noise_k: float
    sh_degree: int
    render: Dict[str, float]
    width: int
    height: int
    radial: Tuple[float, ...]  # OpenCV k1.. of every view
    half_rows: bool = False


def loss_and_grads(params, alive, viewmat, K, target, hp: Hyper, payload=None):
    """(loss, gradients keyed like params, visible rows [N] bool) of one
    view, the parameters unchanged."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    v = gut3d.view(leaves, viewmat, K, hp.radial, hp.width, hp.height, hp.render, hp.sh_degree,
                   alive)
    fields = v.fields.detach()
    img, _, _ = gut3d.composite(fields, v.bins, v.rays, hp.width, hp.height, payload)
    img = img.requires_grad_()
    loss_img = image_loss(img, target, hp.ssim_lambda, hp.half_rows)
    loss_img.backward()
    v_fields = gut3d.composite_backward(fields, v.bins, v.rays, hp.width, hp.height, img.grad,
                                        payload)
    v.fields.backward(v_fields)
    a = alive.to(torch.float32)
    reg = (hp.opacity_reg * (torch.sigmoid(leaves["opacities"]) * a).mean()
           + hp.scale_reg * (torch.exp(leaves["scales"]) * a[:, None]).mean())
    reg.backward()
    grads = {k: leaves[k].grad for k in LEAVES}
    return float(loss_img.detach()) + float(reg.detach()), grads, v.proj.visible & alive


def train_step(params, mu, nu, alive, viewmat, K, target, step: int, hp: Hyper,
               noise: Callable[[], torch.Tensor], payload=None) -> StepOut:
    """One step in place on params, mu, nu."""
    loss, grads, vis = loss_and_grads(params, alive, viewmat, K, target, hp, payload)
    norms = grad_norms(grads, vis)
    update(params, grads, vis, mu, nu, alive, step, hp, noise)
    return StepOut(loss, norms)


def update(params, grads, vis, mu, nu, alive, step: int, hp: Hyper,
           noise: Callable[[], torch.Tensor]) -> None:
    """Selective Adam on the rows `vis`, then the MCMC noise, in place."""
    scale = 0.01 ** (step / hp.max_steps)
    selective_adam(params, grads, mu, nu, vis, hp.lrs, scale)
    with torch.no_grad():
        op = torch.sigmoid(params["opacities"])
        M = quat_to_rotmat(params["quats"]) * torch.exp(params["scales"])[:, None, :]
        n = noise() * (torch.sigmoid(-hp.noise_k * (op - hp.noise_t))
                       * hp.noise_lr * hp.lrs["means"] * scale)[:, None]
        mtn = (M * n[:, :, None]).sum(1)
        delta = (M * mtn[:, None, :]).sum(2)
        params["means"].add_(torch.where(alive[:, None], delta, 0.0))
