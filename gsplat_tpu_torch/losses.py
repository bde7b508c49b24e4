"""Training losses and regularisers.

Port of `gsplat_tpu/losses.py`: l1, mse, windowed SSIM after Wang et al.
2004 with an 11-tap sigma-1.5 Gaussian window and zero padding (:26-98),
disparity-space depth L1, Pearson depth, masked l1 and SSIM, total
variation, the opacity and scale regs, cross entropy, inverse-depth MSE,
log-l1 and the normal cosine loss (:101-225), the reducers and the
per-gaussian regs (:232-279), the lidar losses with the elementwise losses
they resolve by name (:175-202, :282-380), the binocular disparity L1,
relu_sum, weights_reg, identity_distance, the temporal TV and
LinearLambdaScheduler (:383-450), and fused_gaussian_losses (:453-476).
Images are [..., H, W, C], channels last, the rasterizer's output layout.

The blur is two depthwise convolutions.  On the card a float32 convolution
would go through cuDNN in TF32 by default (about three decimal digits), so
`_blur2d` switches TF32 off for its own two calls, as a context and not as
a global setting.
"""

from __future__ import annotations

import functools
import math
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


def depth_l1_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                  scene_scale: float = 1.0) -> torch.Tensor:
    """L1 in disparity space (a depth <= 0 has disparity 0)."""
    disp = torch.where(pred_depth > 0.0, 1.0 / pred_depth, 0.0)
    disp_gt = torch.where(gt_depth > 0.0, 1.0 / gt_depth, 0.0)
    return torch.mean(torch.abs(disp - disp_gt)) * scene_scale


def pearson_depth_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor) -> torch.Tensor:
    """1 - the Pearson correlation of the two depth maps."""
    p = pred_depth.reshape(-1)
    g = gt_depth.reshape(-1)
    p = p - torch.mean(p)
    g = g - torch.mean(g)
    # the norms as sqrt(sum(x * x)): torch.linalg.vector_norm of float32 on
    # the CPU was 0.16% off float64 at 8.3 M entries
    denom = torch.sqrt(torch.sum(p * p)) * torch.sqrt(torch.sum(g * g))
    return 1.0 - torch.sum(p * g) / torch.clamp(denom, min=1e-8)


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - gt| over the masked elements (the mask broadcasts over
    channels)."""
    m = torch.broadcast_to(mask.to(pred.dtype), pred.shape)
    return torch.sum(torch.abs(pred - gt) * m) / torch.clamp(torch.sum(m), min=1.0)


def masked_ssim(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                window_size: int = 11) -> torch.Tensor:
    """SSIM of the masked images, its map averaged over the mask."""
    m = mask.to(pred.dtype)
    w1d = _ssim_window(window_size)
    img1 = pred * m
    img2 = gt * m
    mu1 = _blur2d(img1, w1d)
    mu2 = _blur2d(img2, w1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = torch.clamp(_blur2d(img1 * img1, w1d) - mu1_sq, min=0.0)  # see ssim()
    sigma2_sq = torch.clamp(_blur2d(img2 * img2, w1d) - mu2_sq, min=0.0)
    sigma12 = _blur2d(img1 * img2, w1d) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    mb = torch.broadcast_to(m, ssim_map.shape)
    return torch.sum(ssim_map * mb) / torch.clamp(torch.sum(mb), min=1.0)


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation of [..., H, W, C]."""
    dh = torch.abs(x[..., 1:, :, :] - x[..., :-1, :, :])
    dw = torch.abs(x[..., :, 1:, :] - x[..., :, :-1, :])
    return torch.mean(dh) + torch.mean(dw)


def opacity_reg_loss(opacities: torch.Tensor) -> torch.Tensor:
    """Mean |activated opacity|."""
    return torch.mean(torch.abs(opacities))


def scale_reg_loss(scales: torch.Tensor) -> torch.Tensor:
    """Mean |activated scale|."""
    return torch.mean(torch.abs(scales))


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy against class probabilities (target shaped as the
    logits) or class indices."""
    logp = torch.log_softmax(logits, dim=-1)
    if target.dim() == logits.dim():
        return -torch.mean(torch.sum(target * logp, dim=-1))
    return -torch.mean(torch.gather(logp, -1, target[..., None].long()))


def depth_inverse_mse(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """MSE of inverse depths."""
    return torch.mean((1.0 / (pred + eps) - 1.0 / (target + eps)) ** 2)


def log_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean log(1 + |pred - target|)."""
    return torch.mean(torch.log1p(torch.abs(pred - target)))


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


# ---------------------------------------------------------------------------
# Reducers and per-gaussian regularisers
# ---------------------------------------------------------------------------


def reduce_mean(value: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return torch.mean(value)
    m = mask.to(value.dtype)
    return torch.sum(value * m) / torch.clamp(torch.sum(m), min=1.0)


def _quantile(value: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of all entries, linear between order statistics (a
    sort: torch.quantile caps its input size)."""
    s = torch.sort(value.reshape(-1)).values
    pos = q * (s.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def reduce_quantile(value: torch.Tensor, quantile: float) -> torch.Tensor:
    """Mean of the values at or above the given quantile."""
    q = _quantile(value.detach(), quantile)
    m = (value >= q).to(value.dtype)
    return torch.sum(value * m) / torch.clamp(torch.sum(m), min=1.0)


def reduce_sum(value: torch.Tensor) -> torch.Tensor:
    return torch.sum(value)


def gaussian_scale_reg(scales: torch.Tensor, visibility: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean |scale| sum of the (visible) gaussians' activated scales [N, 3]."""
    return reduce_mean(torch.abs(scales).sum(-1), visibility)


def gaussian_density_reg(densities: torch.Tensor, visibility: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean opacity of the (visible) gaussians."""
    return reduce_mean(densities, visibility)


def gaussian_z_scale_reg(z_scales: torch.Tensor, threshold: float) -> torch.Tensor:
    """Mean relu(z_scale - threshold): a flatness prior."""
    return torch.mean(torch.clamp(z_scales - threshold, min=0.0))


def out_of_bound_loss(positions: torch.Tensor, cuboid_dims: torch.Tensor) -> torch.Tensor:
    """Mean relu(|p| - dims / 2) over the axes."""
    return torch.mean(torch.clamp(torch.abs(positions) - cuboid_dims / 2.0, min=0.0))


def binocular_disparity_l1(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, eps: float = 1e-7) -> torch.Tensor:
    """L1 in inverse-depth space over the pairs where both depths are valid."""
    valid_pred = torch.abs(pred_depth) > eps
    valid_gt = torch.abs(gt_depth) > eps
    pred_inv = 1.0 / torch.where(valid_pred, pred_depth, 1.0)
    gt_inv = 1.0 / torch.where(valid_gt, gt_depth, 1.0)
    m = (valid_pred & valid_gt).to(pred_depth.dtype)
    if mask is not None:
        m = m * mask.to(pred_depth.dtype)
    return masked_l1(pred_inv, gt_inv, m)


def relu_sum(value: torch.Tensor, eps: float) -> torch.Tensor:
    """relu(value - eps).sum()."""
    return torch.clamp(value - eps, min=0.0).sum()


def weights_reg(weights_list, dim: int = 1) -> torch.Tensor:
    """Mean of the squared weight norms."""
    return torch.mean(torch.cat([(w**2).sum(dim).reshape(-1) for w in weights_list]))


def identity_distance(grid: torch.Tensor, num_rows: int = 3, num_cols: int = 4) -> torch.Tensor:
    """Frobenius distance of each affine grid cell from the identity."""
    B = grid.shape[0]
    rest = tuple(grid.shape[2:])
    reshaped = grid.reshape((B, num_rows, num_cols) + rest)
    eye = torch.eye(num_rows, num_cols, dtype=grid.dtype, device=grid.device).reshape(
        (1, num_rows, num_cols) + (1,) * len(rest))
    return torch.sqrt(((reshaped - eye) ** 2).sum(dim=(1, 2)))


def total_variation_temporal(x: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """Total variation along the leading (time) axis of [T, ...] 5-D grids."""
    if x.shape[0] <= 1:
        return torch.zeros((1,), dtype=x.dtype, device=x.device)
    tv_t = torch.mean(torch.diff(x, dim=0) ** 2, dim=(1, 2, 3, 4))
    return tv_t * loss_mask


class LinearLambdaScheduler:
    """A loss weight ramped linearly from (start_step, start) to
    (end_step, end)."""

    def __init__(self, start: float, end: float, start_step: int, end_step: int):
        assert end_step >= start_step
        self.start, self.end = float(start), float(end)
        self.start_step, self.end_step = int(start_step), int(end_step)

    def __call__(self, step) -> torch.Tensor:
        t = (torch.as_tensor(step, dtype=torch.float32) - self.start_step) / max(
            self.end_step - self.start_step, 1
        )
        t = torch.clamp(t, 0.0, 1.0)
        return self.start + t * (self.end - self.start)


def fused_gaussian_losses(
    scales: torch.Tensor,  # [N, 3] activated
    densities: torch.Tensor,  # [N]
    z_scales: torch.Tensor,  # [N]
    positions: torch.Tensor,  # [N, 3]
    cuboid_dims: torch.Tensor,  # [N, 3]
    z_scale_threshold: float = 0.0,
    visibility: Optional[torch.Tensor] = None,
):
    """The four per-gaussian regularisers, unreduced per element:
    (loss_scale [N, 3], loss_density [N], loss_z_scale [N], loss_oob [N, 3])."""
    loss_scale = torch.abs(scales)
    loss_density = torch.abs(densities)
    if visibility is not None:
        v = visibility.reshape(-1)
        loss_scale = loss_scale * v[:, None]
        loss_density = loss_density * v
    loss_z = torch.clamp(z_scales - z_scale_threshold, min=0.0)
    loss_oob = torch.clamp(torch.abs(positions) - cuboid_dims / 2.0, min=0.0)
    return loss_scale, loss_density, loss_z, loss_oob
