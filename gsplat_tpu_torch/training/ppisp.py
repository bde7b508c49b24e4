"""A learned per-camera image signal processor (an analog of PPISP), applied
to the rendered images during training.

Port of `gsplat_tpu/training/ppisp.py:36-101`.  The chain, each stage
smooth, starting at the identity and pulled toward it by the regulariser:

    rendered linear image
      -> per-frame exposure            exp(e_f)
      -> per-camera white balance      diag(exp(g_c))
      -> per-camera colour matrix      I + M_c
      -> per-camera radial vignetting  1 / (1 + v1 r^2 + v2 r^4 + v3 r^6)
      -> per-camera tone curve         x^softplus(gamma + softplus^-1(1))

Elementwise PyTorch; the colour matrix is applied as a sum of three
products (no matrix product, so TF32 never applies).
"""

from __future__ import annotations

from typing import Dict

import torch


def init_ppisp(num_cameras: int, num_frames: int, device=None) -> Dict[str, torch.Tensor]:
    """Identity parameters: exposure [frames] (log scale), wb [cams, 3]
    (log gains), ccm [cams, 3, 3] (offset from I), vignette [cams, 3],
    gamma [cams] (softplus offset)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"exposure": z(num_frames), "wb": z(num_cameras, 3), "ccm": z(num_cameras, 3, 3),
            "vignette": z(num_cameras, 3), "gamma": z(num_cameras)}


# softplus(z) == 1 at z = log(e - 1), as the JAX package computes it in
# float32 (a float64 log(expm1(1)) differs in the last bits)
_SP_INV_1 = 0.54132479429245


def apply_ppisp(params: Dict[str, torch.Tensor], img: torch.Tensor, camera_idx: torch.Tensor,
                frame_idx: torch.Tensor) -> torch.Tensor:
    """The capture chain on rendered images [C, H, W, 3] (or [H, W, 3]) of
    the cameras `camera_idx` [C] and frames `frame_idx` [C]."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
        camera_idx = camera_idx.reshape(-1)
        frame_idx = frame_idx.reshape(-1)
    C, H, W, _ = img.shape
    dev = img.device

    exposure = torch.exp(params["exposure"][frame_idx])  # [C]
    gains = torch.exp(params["wb"][camera_idx])  # [C, 3]
    ccm = torch.eye(3, dtype=torch.float32, device=dev) + params["ccm"][camera_idx]  # [C, 3, 3]
    vig = params["vignette"][camera_idx]  # [C, 3]
    gamma = torch.nn.functional.softplus(params["gamma"][camera_idx] + _SP_INV_1)  # [C]

    x = img * exposure[:, None, None, None]
    x = x * gains[:, None, None, :]
    x = (x[..., 0, None] * ccm[:, None, None, :, 0] + x[..., 1, None] * ccm[:, None, None, :, 1]
         + x[..., 2, None] * ccm[:, None, None, :, 2])

    # the radius from the image centre, normalised
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H - 0.5
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W - 0.5
    r2 = (xs[None, :] ** 2 + ys[:, None] ** 2) / 0.5  # [H, W], ~[0, 1]
    poly = (1.0 + vig[:, 0, None, None] * r2 + vig[:, 1, None, None] * r2 ** 2
            + vig[:, 2, None, None] * r2 ** 3)
    x = x / torch.clamp(poly, min=0.1)[..., None]

    x = torch.clamp(x, min=0.0)
    x = torch.pow(x + 1e-8, gamma[:, None, None, None])
    return x[0] if squeeze else x


def ppisp_regularization(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 pull toward the identity ISP (exposure excluded: frames do differ
    in exposure)."""
    return (torch.mean(params["wb"] ** 2) + torch.mean(params["ccm"] ** 2)
            + torch.mean(params["vignette"] ** 2) + torch.mean(params["gamma"] ** 2))
