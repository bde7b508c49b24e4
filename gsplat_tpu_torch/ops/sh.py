"""Spherical-harmonics color evaluation (degrees 0..4, Sloan fast bases).

Port of `gsplat_tpu/ops/sh.py:21-119`.  Bases are computed elementwise
and contracted with the coefficients by a multiply-and-sum over the basis
axis (no matrix product, so TF32 never applies).
"""

from __future__ import annotations

from typing import Optional

import torch


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_bases(basis_dim: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH bases [..., basis_dim] at unit directions [..., 3];
    basis_dim in {1, 4, 9, 16, 25}."""
    if basis_dim not in (1, 4, 9, 16, 25):
        raise ValueError(f"basis_dim must be a square in [1, 25], got {basis_dim}")
    x, y, z = dirs.unbind(-1)
    out = [torch.full_like(x, 0.2820947917738781)]
    if basis_dim <= 1:
        return torch.stack(out, dim=-1)

    fTmpA = -0.48860251190292
    out += [fTmpA * y, -fTmpA * z, fTmpA * x]
    if basis_dim <= 4:
        return torch.stack(out, dim=-1)

    z2 = z * z
    fTmpB = -1.092548430592079 * z
    fTmpA2 = 0.5462742152960395
    fC1 = x * x - y * y
    fS1 = 2.0 * x * y
    out += [
        fTmpA2 * fS1,
        fTmpB * y,
        0.9461746957575601 * z2 - 0.3153915652525201,
        fTmpB * x,
        fTmpA2 * fC1,
    ]
    if basis_dim <= 9:
        return torch.stack(out, dim=-1)

    fTmpC = -2.285228997322329 * z2 + 0.4570457994644658
    fTmpB3 = 1.445305721320277 * z
    fTmpA3 = -0.5900435899266435
    fC2 = x * fC1 - y * fS1
    fS2 = x * fS1 + y * fC1
    out += [
        fTmpA3 * fS2,
        fTmpB3 * fS1,
        fTmpC * y,
        z * (1.865881662950577 * z2 - 1.119528997770346),
        fTmpC * x,
        fTmpB3 * fC1,
        fTmpA3 * fC2,
    ]
    if basis_dim <= 16:
        return torch.stack(out, dim=-1)

    fTmpD = z * (-4.683325804901025 * z2 + 2.007139630671868)
    fTmpC4 = 3.31161143515146 * z2 - 0.47308734787878
    fTmpB4 = -1.770130769779931 * z
    fTmpA4 = 0.6258357354491763
    fC3 = x * fC2 - y * fS2
    fS3 = x * fS2 + y * fC2
    out += [
        fTmpA4 * fS3,
        fTmpB4 * fS2,
        fTmpC4 * fS1,
        fTmpD * y,
        1.984313483298443 * z2 * (1.865881662950577 * z2 - 1.119528997770346)
        + -1.006230589874905 * (0.9461746957575601 * z2 - 0.3153915652525201),
        fTmpD * x,
        fTmpC4 * fC1,
        fTmpB4 * fC2,
        fTmpA4 * fC3,
    ]
    return torch.stack(out, dim=-1)


def spherical_harmonics(
    degrees_to_use: int,
    dirs: torch.Tensor,  # [..., N, 3]
    coeffs: torch.Tensor,  # [N, K, D] or [..., N, K, D]
    masks: Optional[torch.Tensor] = None,  # [..., N] bool
) -> torch.Tensor:
    """SH colors at directions, [..., N, D].  Only the first
    (degrees_to_use + 1)^2 coefficients contribute."""
    num_bases = num_sh_bases(degrees_to_use)
    K = coeffs.shape[-2]
    if num_bases > K:
        raise ValueError(f"degree {degrees_to_use} needs {num_bases} coefficients, got {K}")
    norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / torch.clamp(norm, min=1e-12)
    bases = eval_sh_bases(num_bases, dirs_n)  # [..., N, B]
    colors = (bases[..., None] * coeffs[..., :num_bases, :]).sum(dim=-2)
    if masks is not None:
        colors = torch.where(masks[..., None], colors, 0.0)
    return colors
