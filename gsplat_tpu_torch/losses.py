"""Training losses of the 3DGS and 2DGS trainers.

Port of `gsplat_tpu/losses.py:26-98` (l1, mse, windowed SSIM after Wang et
al. 2004 with an 11-tap sigma-1.5 Gaussian window and zero padding),
:222-225 (the normal-consistency loss of the surfel trainer) and :175-202,
:282-380 (the lidar losses of the AV trainer, with the elementwise losses
they resolve by name).
Images are [..., H, W, C], channels last, the rasterizer's output layout.

The blur is two depthwise convolutions.  On the card a float32 convolution
would go through cuDNN in TF32 by default (about three decimal digits), so
`_blur2d` switches TF32 off for its own two calls, as a context and not as
a global setting.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


@functools.lru_cache(maxsize=8)
def _ssim_window(window_size: int) -> np.ndarray:
    """The normalized 1D Gaussian window (sigma 1.5), float64 numpy."""
    sigma = 1.5
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    return g / g.sum()


def _blur2d(img: torch.Tensor, w1d: np.ndarray) -> torch.Tensor:
    """Separable depthwise Gaussian blur over [..., H, W, C], zero-padded,
    in full float32."""
    ws = len(w1d)
    pad = ws // 2
    lead = tuple(img.shape[:-3])
    H, W, C = img.shape[-3:]
    x = img.reshape((-1, H, W, C)).permute(0, 3, 1, 2)  # NCHW view for conv2d
    w = torch.as_tensor(w1d, dtype=img.dtype, device=img.device)
    kh = w.reshape(1, 1, ws, 1).expand(C, 1, ws, 1)
    kw = w.reshape(1, 1, 1, ws).expand(C, 1, 1, ws)
    with torch.backends.cudnn.flags(allow_tf32=False):
        x = F.conv2d(x, kh, padding=(pad, 0), groups=C)
        x = F.conv2d(x, kw, padding=(0, pad), groups=C)
    return x.permute(0, 2, 3, 1).reshape(lead + (H, W, C))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [..., H, W, C] images in [0, 1]."""
    w1d = _ssim_window(window_size)
    mu1 = _blur2d(img1, w1d)
    mu2 = _blur2d(img2, w1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # Variances are clamped at 0: float32 cancellation in flat regions can
    # make E[x^2] - E[x]^2 slightly negative and push SSIM above 1.
    sigma1_sq = torch.clamp(_blur2d(img1 * img1, w1d) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_blur2d(img2 * img2, w1d) - mu2_sq, min=0.0)
    sigma12 = _blur2d(img1 * img2, w1d) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return torch.mean(ssim_map)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """1 - SSIM."""
    return 1.0 - ssim(img1, img2, window_size)


def normal_cosine_loss(pred_normal: torch.Tensor, gt_normal: torch.Tensor) -> torch.Tensor:
    """Mean of 1 - cos between unit normals [..., 3]."""
    return torch.mean(1.0 - (pred_normal * gt_normal).sum(dim=-1))


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta)))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(pred, 1e-12, 1.0 - 1e-12)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def bce_with_logits_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_clipped(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.001) -> torch.Tensor:
    """BCE with the prediction clipped to [eps, 1 - eps]."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


_LOSS_FNS = {
    "l1": l1_loss,
    "mse": mse_loss,
    "huber": huber_loss,
    "smooth_l1": smooth_l1_loss,
    "bce": bce_loss,
    "bce_clipped": bce_clipped,
    "bce_with_logits": bce_with_logits_loss,
}


def _resolve_loss_fn(loss_fn):
    """A loss function, or its name in _LOSS_FNS."""
    if callable(loss_fn):
        return loss_fn
    if loss_fn not in _LOSS_FNS:
        raise ValueError(f"unknown loss_fn {loss_fn!r}")
    return _LOSS_FNS[loss_fn]


def _elementwise(fn, pred, target):
    """fn per element for l1 and mse (whose functions reduce); any other
    fn is applied as it is, and a reducing one gives its mean, as in the
    JAX package."""
    if fn is l1_loss:
        return torch.abs(pred - target)
    if fn is mse_loss:
        return (pred - target) ** 2
    return fn(pred, target)


def _masked_mean(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(v)
    m = mask.reshape(v.shape).to(v.dtype)
    return (v * m).sum() / torch.clamp(m.sum(), min=1.0)


def lidar_distance_loss(pred_distance: torch.Tensor, gt_distance: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None, loss_fn="l1") -> torch.Tensor:
    """Loss on the lidar hit distance, in distance space, over valid rays."""
    v = _elementwise(_resolve_loss_fn(loss_fn), pred_distance.reshape(-1),
                     gt_distance.reshape(-1))
    return _masked_mean(v, valid_mask)


def lidar_intensity_loss(pred_intensity: torch.Tensor, gt_intensity: torch.Tensor,
                         valid_mask: Optional[torch.Tensor] = None, loss_fn="l1") -> torch.Tensor:
    """Loss on the lidar return intensity."""
    v = _elementwise(_resolve_loss_fn(loss_fn), pred_intensity.reshape(-1),
                     gt_intensity.reshape(-1))
    return _masked_mean(v, valid_mask)


def lidar_raydrop_loss(pred_raydrop: torch.Tensor, gt_raydrop: torch.Tensor,
                       valid_mask: Optional[torch.Tensor] = None,
                       loss_fn="bce_with_logits") -> torch.Tensor:
    """Loss on the lidar ray-drop prediction."""
    v = _elementwise(_resolve_loss_fn(loss_fn), pred_raydrop.reshape(-1),
                     gt_raydrop.reshape(-1).to(torch.float32))
    return _masked_mean(v, valid_mask)


def lidar_background_loss(pred_opacity: torch.Tensor, background_mask: torch.Tensor,
                          valid_mask: Optional[torch.Tensor] = None,
                          loss_fn="bce") -> torch.Tensor:
    """Opacity on background (sky) lidar rays: the target is 0 there and 1
    on foreground rays."""
    pred = torch.clamp(pred_opacity.reshape(-1), 0.0, 1.0)
    target = (~background_mask.reshape(-1).to(torch.bool)).to(torch.float32)
    return _masked_mean(_elementwise(_resolve_loss_fn(loss_fn), pred, target), valid_mask)
