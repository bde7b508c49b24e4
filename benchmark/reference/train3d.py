"""Plain PyTorch reference of one 3DGS training step with the MCMC strategy
between refinements: render (splat3d), loss, backward, selective Adam and
the MCMC positional noise.

  * loss = (1 - ssim_lambda) L1 + ssim_lambda (1 - SSIM) of the render
    clamped to [0, 1] against the target, SSIM with an 11-tap gaussian
    window (sigma 1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2, variances
    clamped at 0; plus opacity_reg * mean(sigmoid(opacity)) and scale_reg *
    mean(exp(scales)) over the alive rows (dead rows count as 0);
  * selective Adam (b1 0.9, b2 0.999, eps 1e-8, no bias correction) on the
    rows visible in the view, with the means' rate scaled by
    0.01^(step / max_steps) and by the scene scale;
  * then means += Sigma (n sigmoid(-k (opacity - t)) noise_lr lr_means) on
    alive rows, n standard normal [cap, 3], Sigma = (R S)(R S)^T of the
    updated parameters (3DGS as MCMC, Kheradmand et al. 2024).  `noise`
    draws n, one call per step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import splat3d

LEAVES = ("means", "quats", "scales", "opacities", "sh0", "shN")


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of [H, W, C], zero padded."""
    w = torch.as_tensor(_window(), dtype=img.dtype, device=img.device)
    C = img.shape[-1]
    x = img.permute(2, 0, 1)[None]
    x = F.conv2d(x, w.reshape(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(5, 0), groups=C)
    x = F.conv2d(x, w.reshape(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, 5), groups=C)
    return x[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu1, mu2 = _blur(a), _blur(b)
    s1 = torch.clamp(_blur(a * a) - mu1 * mu1, min=0.0)
    s2 = torch.clamp(_blur(b * b) - mu2 * mu2, min=0.0)
    s12 = _blur(a * b) - mu1 * mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    return m.mean()


def image_loss(img: torch.Tensor, target: torch.Tensor, ssim_lambda: float,
               half_rows: bool = False) -> torch.Tensor:
    """`half_rows`: the fault that leaves the lower half of the image out
    and takes the mean over the rest (read on the chip to bound a limit)."""
    if half_rows:
        img, target = img[: img.shape[0] // 2], target[: target.shape[0] // 2]
    img = torch.clamp(img, 0.0, 1.0)
    return ((1.0 - ssim_lambda) * (img - target).abs().mean()
            + ssim_lambda * (1.0 - ssim(img, target)))


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
    half_rows: bool = False


class StepOut(NamedTuple):
    loss: float
    grad_norms: Dict[str, float]  # of the gradient Adam takes: visible rows only


def train_step(params, mu, nu, alive, viewmat, K, target, step: int, hp: Hyper,
               noise: Callable[[], torch.Tensor], payload=None) -> StepOut:
    """One step in place on params, mu, nu."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    v = splat3d.view(leaves, viewmat, K, hp.width, hp.height, hp.render, hp.sh_degree, alive)
    fields = v.fields.detach()
    img, _, _ = splat3d.composite(fields, v.bins, hp.width, hp.height, payload)
    img = img.requires_grad_()
    loss_img = image_loss(img, target, hp.ssim_lambda, hp.half_rows)
    loss_img.backward()
    v_fields = splat3d.composite_backward(fields, v.bins, hp.width, hp.height, img.grad, payload)
    v.fields.backward(v_fields)
    a = alive.to(torch.float32)
    reg = (hp.opacity_reg * (torch.sigmoid(leaves["opacities"]) * a).mean()
           + hp.scale_reg * (torch.exp(leaves["scales"]) * a[:, None]).mean())
    reg.backward()
    vis = v.proj.visible & alive
    grads = {k: leaves[k].grad for k in LEAVES}
    norms = grad_norms(grads, vis)
    del leaves, v, fields, img
    scale = 0.01 ** (step / hp.max_steps)
    selective_adam(params, grads, mu, nu, vis, hp.lrs, scale)
    with torch.no_grad():
        op = torch.sigmoid(params["opacities"])
        M = splat3d.quat_to_rotmat(params["quats"]) * torch.exp(params["scales"])[:, None, :]
        n = noise() * (torch.sigmoid(-hp.noise_k * (op - hp.noise_t))
                       * hp.noise_lr * hp.lrs["means"] * scale)[:, None]
        mtn = (M * n[:, :, None]).sum(1)
        delta = (M * mtn[:, None, :]).sum(2)
        params["means"].add_(torch.where(alive[:, None], delta, 0.0))
    return StepOut(float(loss_img.detach()) + float(reg.detach()), norms)


@torch.no_grad()
def selective_adam(params, grads, mu, nu, vis, lrs, means_scale: float) -> None:
    """Adam without bias correction on the visible rows, in place."""
    for k in LEAVES:
        p, g, m, s = params[k], grads[k], mu[k], nu[k]
        lr = lrs[k] * (means_scale if k == "means" else 1.0)
        m_new = 0.9 * m + 0.1 * g
        s_new = 0.999 * s + 0.001 * g * g
        p_new = p - lr * m_new / (torch.sqrt(s_new) + 1e-8)
        w = vis.reshape((-1,) + (1,) * (p.dim() - 1))
        p.copy_(torch.where(w, p_new, p))
        m.copy_(torch.where(w, m_new, m))
        s.copy_(torch.where(w, s_new, s))


def grad_norms(grads, vis) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(g[vis], dtype=torch.float64))
            for k, g in grads.items()}


def follow(params, alive, steps: List[int], views, targets, hp: Hyper,
           noise: Callable[[], torch.Tensor], payload=None, step_fn=None):
    """Run the steps from fresh Adam moments: (losses, the first step's
    gradient norms, the norm of each leaf's change after the last).
    `step_fn` is the model's step (train_step here)."""
    step_fn = step_fn or train_step
    start = {k: params[k].clone() for k in LEAVES}
    mu = {k: torch.zeros_like(params[k]) for k in LEAVES}
    nu = {k: torch.zeros_like(params[k]) for k in LEAVES}
    losses, first = [], None
    for step, (vm, K), target in zip(steps, views, targets):
        out = step_fn(params, mu, nu, alive, vm, K, target(), step, hp, noise, payload)
        losses.append(out.loss)
        first = out.grad_norms if first is None else first
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k], dtype=torch.float64))
              for k in LEAVES}
    return losses, first, change
