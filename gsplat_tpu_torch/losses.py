"""Training losses of the 3DGS and 2DGS trainers.

Port of `gsplat_tpu/losses.py:26-98` (l1, mse, windowed SSIM after Wang et
al. 2004 with an 11-tap sigma-1.5 Gaussian window and zero padding) and
:222-225 (the normal-consistency loss of the surfel trainer).
Images are [..., H, W, C], channels last, the rasterizer's output layout.

The blur is two depthwise convolutions.  On the card a float32 convolution
would go through cuDNN in TF32 by default (about three decimal digits), so
`_blur2d` switches TF32 off for its own two calls, as a context and not as
a global setting.
"""

from __future__ import annotations

import functools

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
