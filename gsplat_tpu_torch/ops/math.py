"""Core Gaussian math: quaternions and covariance construction.

Port of `gsplat_tpu/ops/math.py` (normalize :19, quat_to_rotmat :32,
rotmat_to_quat :53, quat_scale_to_covar_preci :90, quat_multiply :163,
quat_inverse :178, quat_rotate :183, quat_slerp :191, world_to_cam :212).  Quaternions are wxyz and need not be
normalized.  The 3x3 algebra is written elementwise, so no matrix product
(and no TF32) touches it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `axis`; zero vectors stay zero.

    The clamp sits on the squared sum, as in the JAX package, so the
    gradient at a zero vector is finite.
    """
    s = torch.sum(x * x, dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp(s, min=eps * eps))


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(Unnormalized) wxyz quaternions [..., 4] -> rotation matrices [..., 3, 3]."""
    quats = normalize(quats, axis=-1)
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


def rotmat_to_quat(rotmats: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit wxyz quaternions [..., 4], w >= 0.

    Shepperd's construction: of four candidates, the one whose leading
    entry is largest, chosen by select so that autograd sees every branch.
    """
    m = rotmats
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = (
        (1.0 + tr, m21 - m12, m02 - m20, m10 - m01),
        (m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20),
        (m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21),
        (m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11),
    )
    q0, q1, q2, q3 = (torch.stack(c, dim=-1) for c in cands)
    c1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    c2 = (m11 >= m22)[..., None]
    q = torch.where((tr > 0.0)[..., None], q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    q = normalize(q, axis=-1, eps=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit wxyz quaternion: its conjugate."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit wxyz quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical linear interpolation of wxyz quaternions on the short arc;
    a plain lerp where the two are nearly parallel."""
    q0 = normalize(q0, axis=-1, eps=1e-12)
    q1 = normalize(q1, axis=-1, eps=1e-12)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    near = dot > 1.0 - 1e-6
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_theta)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_theta)
    return normalize(w0 * q0 + w1 * q1, axis=-1, eps=1e-12)


def world_to_cam(
    means: torch.Tensor,  # [..., N, 3]
    covars: torch.Tensor,  # [..., N, 3, 3]
    viewmats: torch.Tensor,  # [..., C, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Means and covariances in each camera's frame: means_c [..., C, N, 3]
    = R m + t, covars_c [..., C, N, 3, 3] = R S R^T, elementwise in float32."""
    R = viewmats[..., :3, :3][..., :, None, :, :]  # [..., C, 1, 3, 3]
    t = viewmats[..., :3, 3][..., :, None, :]  # [..., C, 1, 3]
    m = means[..., None, :, :]  # [..., 1, N, 3]
    means_c = torch.stack(
        [R[..., i, 0] * m[..., 0] + R[..., i, 1] * m[..., 1] + R[..., i, 2] * m[..., 2]
         for i in range(3)], dim=-1) + t
    S = covars[..., None, :, :, :]  # [..., 1, N, 3, 3]
    RS = [[R[..., i, 0] * S[..., 0, j] + R[..., i, 1] * S[..., 1, j] + R[..., i, 2] * S[..., 2, j]
           for j in range(3)] for i in range(3)]
    covars_c = torch.stack(
        [torch.stack([RS[i][0] * R[..., l, 0] + RS[i][1] * R[..., l, 1] + RS[i][2] * R[..., l, 2]
                      for l in range(3)], dim=-1) for i in range(3)], dim=-2)
    return means_c, covars_c
