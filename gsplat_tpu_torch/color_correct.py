"""Per-image colour correction for eval metrics (multinerf style).

Port of `gsplat_tpu/color_correct.py:14-76`: least-squares colour warps
from a rendered image toward a reference, with saturation-aware masking.
The least squares are torch.linalg.lstsq of the masked system, whose
answer the JAX package takes from regularized normal equations (1e-6 on
the diagonal); the two agree to well under 1e-5 on well-posed images.
"""

from __future__ import annotations

import torch


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The least-squares x of A x = b (A [M, K], b [M])."""
    return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]


def color_correct_quadratic(img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5,
                            eps: float = 0.5 / 255) -> torch.Tensor:
    """Quadratic colour warp of `img` toward `ref`."""
    assert img.shape[-1] == ref.shape[-1]
    C = img.shape[-1]
    img_mat = img.reshape(-1, C)
    ref_mat = ref.reshape(-1, C)

    def unclipped(z):
        return (z >= eps) & (z <= 1 - eps)

    mask0 = unclipped(img_mat)
    for _ in range(num_iters):
        a_mat = [img_mat[:, c : c + 1] * img_mat[:, c:] for c in range(C)]  # quadratic
        a_mat.append(img_mat)  # linear
        a_mat.append(torch.ones_like(img_mat[:, :1]))  # bias
        a_mat = torch.cat(a_mat, dim=-1)
        warp = []
        for c in range(C):
            b = ref_mat[:, c]
            m = mask0[:, c] & unclipped(img_mat[:, c]) & unclipped(b)
            warp.append(_lstsq(torch.where(m[:, None], a_mat, 0.0), torch.where(m, b, 0.0)))
        warp = torch.stack(warp, dim=-1)
        # the warp applied elementwise: no matrix product, so no TF32 on the card
        img_mat = torch.clamp((a_mat[:, :, None] * warp[None]).sum(1), 0.0, 1.0)
    return img_mat.reshape(img.shape)


def color_correct_affine(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-channel affine fit ref -> img, inverted and applied to img."""
    assert img.shape[-1] == ref.shape[-1]
    C = img.shape[-1]
    img_mat = img.reshape(-1, C)
    ref_mat = ref.reshape(-1, C)
    out = []
    for c in range(C):
        x = ref_mat[:, c]
        y = img_mat[:, c]
        mx, my = x.mean(), y.mean()
        cov = torch.mean((x - mx) * (y - my))
        var = torch.clamp(torch.mean((x - mx) ** 2), min=1e-12)
        a = cov / var  # y ~ a x + b
        b = my - a * mx
        out.append((y - b) / torch.where(torch.abs(a) < 1e-8, 1.0, a))  # x ~ (y - b) / a
    return torch.clamp(torch.stack(out, dim=-1).reshape(img.shape), 0.0, 1.0)
