"""Evaluation metrics: PSNR, LPIPS (VGG) from a local weights file, and the
fixed-random-feature perceptual proxy.

Port of gsplat_tpu/training/metrics.py.  SSIM is `losses.ssim`.

`lpips` needs the VGG16 features and LPIPS heads as an `.npz` of arrays
`conv{i}_w`, `conv{i}_b` (i in 0..12, OIHW) and `lin{j}_w` (j in 0..4,
[C_j]); nothing is fetched.  Without a weights file callers report None.

`lpips_proxy` draws its conv weights as the JAX package does,
`jax.random.normal` from `PRNGKey(seed)` split once per layer (threefry
2x32, the partitionable layout), here in numpy: the same bits, the same
uniform in (-1, 1) and the same float32 inverse error function (XLA's
polynomial), so the weights agree with JAX's to a few float32 ulps.

The convolutions run in NCHW on OIHW weights, in full float32 (TF32 off
for cuDNN inside these functions); the 2x2 max pool drops an odd last row
or column, as JAX's VALID reduce_window does.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (out_channels, convs in the block)
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def psnr(img: torch.Tensor, ref: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME convolution (odd kernels: symmetric padding)."""
    return F.conv2d(x, w_oihw, padding=w_oihw.shape[-1] // 2)


def _vgg_features(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """x: [B, 3, H, W] in [-1, 1].  The block taps, NCHW."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[:, None, None]
    x = (x - shift) / scale
    taps = []
    ci = 0
    for _, n_convs in _VGG_BLOCKS:
        for _ in range(n_convs):
            x = torch.relu(_conv(x, w[f"conv{ci}_w"]) + w[f"conv{ci}_b"][:, None, None])
            ci += 1
        taps.append(x)
        x = F.max_pool2d(x, 2)
    return taps


def load_lpips_weights(weights_path: str, device=None) -> Dict[str, torch.Tensor]:
    with np.load(weights_path) as w:
        return {k: torch.as_tensor(w[k], dtype=torch.float32, device=device) for k in w.files}


def lpips(img0: torch.Tensor, img1: torch.Tensor, weights) -> torch.Tensor:
    """LPIPS(VGG) distance per batch element [B] of images [B, H, W, 3] in
    [0, 1]: inputs scaled to [-1, 1], the VGG16 block taps, each unit
    normalized over its channels, squared differences weighted by the 1x1
    heads, the spatial mean, summed over the taps."""
    if isinstance(weights, (str, os.PathLike)):
        weights = load_lpips_weights(weights, device=img0.device)
    with torch.backends.cudnn.flags(allow_tf32=False):
        f0 = _vgg_features(_nchw(img0 * 2.0 - 1.0), weights)
        f1 = _vgg_features(_nchw(img1 * 2.0 - 1.0), weights)
    total = 0.0
    for j, (a, b) in enumerate(zip(f0, f1)):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        lin = weights[f"lin{j}_w"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1), dim=(1, 2))
    return total


# ---------------------------------------------------------------------------
# JAX's random normals in numpy (threefry 2x32, partitionable layout)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 counters (jax.random's)."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = (x0 + ks[0]).astype(np.uint32)
    x1 = (x1 + ks[1]).astype(np.uint32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1).astype(np.uint32)
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))).astype(np.uint32)
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
        x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def _split(key):
    """jax.random.split(key) into 2: counters (0, i)."""
    b0, b1 = _threefry2x32(key[0], key[1], np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    return (int(b0[0]), int(b1[0])), (int(b0[1]), int(b1[1]))


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' single-precision
    polynomials), in float32."""
    f32 = np.float32
    lt_c = [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
            -0.00125372503, -0.00417768164, 0.246640727, 1.50140941]
    ge_c = [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
            -0.0076224613, 0.00943887047, 1.00167406, 2.83297682]
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(lt_c[0]), f32(ge_c[0])).astype(f32)
    for a, b in zip(lt_c[1:], ge_c[1:]):
        p = (np.where(lt, f32(a), f32(b)) + p * w).astype(f32)
    out = (p * x).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), out).astype(f32)


def _normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(np.uint32),
                           (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (b0 ^ b1).reshape(shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)


# ---------------------------------------------------------------------------
# Self-contained perceptual distance (no pretrained weights)
# ---------------------------------------------------------------------------

_PROXY_CHANNELS = (32, 64, 128)


def proxy_weights(seed: int = 0) -> List[np.ndarray]:
    """The proxy's fixed random conv stack, HWIO float32: He-normal 3x3
    kernels of 32, 64 and 128 channels, as gsplat_tpu/training/metrics.py:
    _proxy_weights draws them."""
    key = (0, seed & 0xFFFFFFFF)  # jax.random.PRNGKey(seed)
    ws = []
    cin = 3
    for cout in _PROXY_CHANNELS:
        key, k1 = _split(key)
        w = _normal(k1, (3, 3, cin, cout))
        ws.append((w * np.float32(np.sqrt(np.float32(2.0 / (9 * cin))))).astype(np.float32))
        cin = cout
    return ws


def lpips_proxy(img1: torch.Tensor, img2: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Perceptual distance from fixed random conv features of images
    [.., H, W, 3] in [0, 1]: per tap, unit-normalize over the channels, the
    channel sum of squared differences, the spatial mean; summed over the
    taps.  0 for identical images.  Not comparable to published LPIPS
    numbers (reported as `lpips_proxy`).  Returns [B], or a scalar for
    unbatched inputs."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    ws = [torch.as_tensor(w, device=img1.device).permute(3, 2, 0, 1) for w in proxy_weights(seed)]
    total = 0.0
    with torch.backends.cudnn.flags(allow_tf32=False):
        x1, x2 = _nchw(img1 * 2.0 - 1.0), _nchw(img2 * 2.0 - 1.0)
        for i, w in enumerate(ws):
            x1, x2 = torch.relu(_conv(x1, w)), torch.relu(_conv(x2, w))
            na = x1 / torch.sqrt(torch.sum(x1 * x1, 1, keepdim=True) + 1e-10)
            nb = x2 / torch.sqrt(torch.sum(x2 * x2, 1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((na - nb) ** 2, dim=1), dim=(1, 2))
            if i + 1 < len(ws):
                x1, x2 = F.max_pool2d(x1, 2), F.max_pool2d(x2, 2)
    return total[0] if squeeze else total
