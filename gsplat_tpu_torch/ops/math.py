"""Core Gaussian math: quaternions and covariance construction.

Port of `gsplat_tpu/ops/math.py` (normalize :19, quat_to_rotmat :32,
quat_scale_to_covar_preci :90).  Quaternions are wxyz and need not be
normalized.  The 3x3 algebra is written elementwise, so no matrix product
(and no TF32) touches it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`; zero vectors stay zero.

    The clamp sits on the squared sum, as in the JAX package, so the
    gradient at a zero vector is finite.
    """
    s = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(s, min=eps * eps))


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(Unnormalized) wxyz quaternions [..., 4] -> rotation matrices [..., 3, 3]."""
    quats = normalize(quats, dim=-1)
    w, x, y, z = quats.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return rot.reshape(quats.shape[:-1] + (3, 3))


def sym_mmT(M: torch.Tensor) -> torch.Tensor:
    """M @ M^T for [..., 3, 3], elementwise in full f32."""
    rows = [M[..., i, :] for i in range(3)]

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    e = {(i, j): dot(rows[i], rows[j]) for i in range(3) for j in range(i, 3)}
    return torch.stack(
        [
            torch.stack([e[(0, 0)], e[(0, 1)], e[(0, 2)]], dim=-1),
            torch.stack([e[(0, 1)], e[(1, 1)], e[(1, 2)]], dim=-1),
            torch.stack([e[(0, 2)], e[(1, 2)], e[(2, 2)]], dim=-1),
        ],
        dim=-2,
    )


def _to_triu(mats: torch.Tensor) -> torch.Tensor:
    """Symmetric [..., 3, 3] -> upper triangle [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [
            mats[..., 0, 0], mats[..., 0, 1], mats[..., 0, 2],
            mats[..., 1, 1], mats[..., 1, 2], mats[..., 2, 2],
        ],
        dim=-1,
    )


def triu_to_full(triu: torch.Tensor) -> torch.Tensor:
    """Upper triangle [..., 6] -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = triu.unbind(-1)
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def quat_scale_to_covar_preci(
    quats: torch.Tensor,
    scales: torch.Tensor,
    compute_covar: bool = True,
    compute_preci: bool = True,
    triu: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """3D covariance R S S^T R^T and/or precision from quat + scale."""
    R = quat_to_rotmat(quats)
    covars = precis = None
    if compute_covar:
        covars = sym_mmT(R * scales[..., None, :])
        if triu:
            covars = _to_triu(covars)
    if compute_preci:
        precis = sym_mmT(R * (1.0 / scales)[..., None, :])
        if triu:
            precis = _to_triu(precis)
    return covars, precis
