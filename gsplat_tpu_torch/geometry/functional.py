"""Quaternion, SE(3) pose and trajectory functions on tensors.

Port of `gsplat_tpu/geometry/functional.py:54-363`.  Quaternions here are
xyzw, as in upstream gsplat's geometry package (the splatting core uses
wxyz, ops/math.py).  Everything is elementwise and differentiable by
autograd, on the device of the inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..ops.math import rotmat_to_quat

__all__ = [
    "frame_transform_poses_tquat",
    "se3_interpolate_tracks",
    "se3pose_compose",
    "se3pose_from_matrix",
    "se3pose_inverse_transform_direction",
    "se3pose_inverse_transform_point",
    "se3pose_to_inverse_matrix",
    "se3pose_to_matrix",
    "se3pose_transform_direction",
    "se3pose_transform_point",
    "trajectory_get_rotation_2poses",
    "trajectory_transform_point_1pose",
    "trajectory_transform_point_2poses",
    "quat_angular_distance",
    "quat_conjugate",
    "quat_from_axis_angle",
    "quat_identity",
    "quat_inverse",
    "quat_lerp",
    "quat_manifold_interp",
    "quat_multiply",
    "quat_normalize_safe",
    "quat_rotate_vector",
    "quat_slerp",
    "quat_to_matrix",
]

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# quaternions (xyzw)
# ---------------------------------------------------------------------------


def quat_identity(shape=(), dtype=torch.float32) -> Tensor:
    """Identity quaternions [*shape, 4], on torch's default device."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype)
    q[..., 3] = 1.0
    return q


def _identity_like(q: Tensor) -> Tensor:
    return torch.zeros_like(q).index_fill_(-1, torch.tensor([3], device=q.device), 1.0)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _t(t, like: Tensor) -> Tensor:
    """t as a tensor of like's dtype, with a trailing axis when it has one
    axis fewer than the quaternions."""
    tt = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    return tt[..., None] if tt.dim() == like.dim() - 1 else tt


def quat_normalize_safe(q: Tensor, eps: float = 1e-12) -> Tensor:
    """Normalize; near-zero quaternions fall back to identity."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    safe = q / torch.clamp(n, min=eps)
    return torch.where(n > eps, safe, _identity_like(q))


def quat_conjugate(q: Tensor) -> Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_inverse(q: Tensor) -> Tensor:
    return quat_conjugate(q) / torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-20)


def quat_multiply(q1: Tensor, q2: Tensor) -> Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_rotate_vector(q: Tensor, v: Tensor) -> Tensor:
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_axis_angle(axis: Tensor, angle) -> Tensor:
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_to_matrix(q: Tensor) -> Tensor:
    q = quat_normalize_safe(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_angular_distance(q1: Tensor, q2: Tensor) -> Tensor:
    """Geodesic angle between rotations (radians)."""
    q1 = quat_normalize_safe(q1)
    q2 = quat_normalize_safe(q2)
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0))


def quat_lerp(q1: Tensor, q2: Tensor, t) -> Tensor:
    """Normalized linear interpolation along the short arc."""
    q1 = quat_normalize_safe(q1)
    q2 = quat_normalize_safe(q2)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    return quat_normalize_safe(q1 + (q2 - q1) * _t(t, q1))


def quat_slerp(q1: Tensor, q2: Tensor, t) -> Tensor:
    """Spherical interpolation (short arc; lerp near parallel)."""
    q1 = quat_normalize_safe(q1)
    q2 = quat_normalize_safe(q2)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    dot = torch.clamp(torch.abs(dot), 0.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-7))
    sin_t = torch.sin(theta)
    tt = _t(t, q1)
    near = dot > 1.0 - 1e-6
    w0 = torch.where(near, 1.0 - tt, torch.sin((1.0 - tt) * theta) / sin_t)
    w1 = torch.where(near, tt, torch.sin(tt * theta) / sin_t)
    return quat_normalize_safe(w0 * q1 + w1 * q2)


def quat_manifold_interp(q1: Tensor, q2: Tensor, t) -> Tensor:
    """q1 * exp(t * log(q1^-1 * q2)): interpolation on SO(3)."""
    q1 = quat_normalize_safe(q1)
    q2 = quat_normalize_safe(q2)
    d = quat_normalize_safe(quat_multiply(quat_conjugate(q1), q2))
    w = torch.clamp(d[..., 3:4], -1.0, 1.0)
    angle = 2.0 * torch.arccos(torch.abs(w))
    sign = torch.where(w < 0, -1.0, 1.0)
    sin_half = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-20))
    axis = sign * d[..., :3] / sin_half
    small = angle[..., 0] < 1e-6
    half = 0.5 * _t(t, q1) * angle
    step = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    step = torch.where(small[..., None], _identity_like(step), step)
    return quat_normalize_safe(quat_multiply(q1, step))


# ---------------------------------------------------------------------------
# SE(3) poses: (translation [.., 3], rotation xyzw [.., 4])
# ---------------------------------------------------------------------------


def se3pose_compose(t1: Tensor, q1: Tensor, t2: Tensor, q2: Tensor) -> Tuple[Tensor, Tensor]:
    """Compose pose1 o pose2: x -> R1 (R2 x + t2) + t1."""
    q1n = quat_normalize_safe(q1)
    return quat_rotate_vector(q1n, t2) + t1, quat_multiply(q1n, q2)


def se3pose_transform_point(t: Tensor, q: Tensor, p: Tensor) -> Tensor:
    return quat_rotate_vector(quat_normalize_safe(q), p) + t


def se3pose_transform_direction(t: Tensor, q: Tensor, d: Tensor) -> Tensor:
    return quat_rotate_vector(quat_normalize_safe(q), d)


def se3pose_inverse_transform_point(t: Tensor, q: Tensor, p: Tensor) -> Tensor:
    return quat_rotate_vector(quat_conjugate(quat_normalize_safe(q)), p - t)


def se3pose_inverse_transform_direction(t: Tensor, q: Tensor, d: Tensor) -> Tensor:
    return quat_rotate_vector(quat_conjugate(quat_normalize_safe(q)), d)


def _homogeneous(R: Tensor, t: Tensor) -> Tensor:
    M = torch.zeros(t.shape[:-1] + (4, 4), dtype=t.dtype, device=t.device)
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


def se3pose_to_matrix(t: Tensor, q: Tensor) -> Tensor:
    return _homogeneous(quat_to_matrix(q), t)


def se3pose_to_inverse_matrix(t: Tensor, q: Tensor) -> Tensor:
    Rt = quat_to_matrix(q).transpose(-1, -2)
    # R^T t elementwise: no matrix product, so TF32 never applies on the card
    return _homogeneous(Rt, -(Rt * t[..., None, :]).sum(-1))


def se3pose_from_matrix(M: Tensor) -> Tuple[Tensor, Tensor]:
    """4x4 matrices -> (translation, xyzw quaternion)."""
    q_wxyz = rotmat_to_quat(M[..., :3, :3])
    return M[..., :3, 3], torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)


def frame_transform_poses_tquat(
    poses_t: Tensor,  # [N, 3]
    poses_q: Tensor,  # [N, 4] xyzw
    rotation: Tuple[float, float, float, float],  # frame quaternion, xyzw
    translation: Tuple[float, float, float],
) -> Tuple[Tensor, Tensor]:
    """A fixed frame transform applied to pose arrays."""
    qf = torch.as_tensor(rotation, dtype=poses_q.dtype, device=poses_q.device)
    tf = torch.as_tensor(translation, dtype=poses_t.dtype, device=poses_t.device)
    return se3pose_compose(tf.expand(poses_t.shape), qf.expand(poses_q.shape), poses_t, poses_q)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


def _traj_alpha(time0, time1, query_time):
    span = time1 - time0
    safe = torch.where(span == 0, 1.0, span)
    return torch.where(span == 0, 0.0, (query_time - time0) / safe)


def _out_of_bounds(time0, time1, query_time):
    lo = torch.minimum(time0, time1)
    hi = torch.maximum(time0, time1)
    return (query_time < lo) | (query_time > hi)


def trajectory_get_rotation_2poses(
    trans0, rot0, time0, trans1, rot1, time1, query_time
) -> Dict[str, Tensor]:
    """Slerped rotation along a 2-pose trajectory (extrapolating)."""
    alpha = _traj_alpha(time0, time1, query_time)
    return {"rotation": quat_slerp(rot0, rot1, alpha),
            "out_of_bounds": _out_of_bounds(time0, time1, query_time)}


def trajectory_transform_point_2poses(
    trans0, rot0, time0, trans1, rot1, time1, point, query_time
) -> Dict[str, Tensor]:
    """Points transformed by the pose interpolated (or extrapolated) at
    query_time."""
    alpha = _traj_alpha(time0, time1, query_time)
    t = trans0 + (trans1 - trans0) * alpha[..., None]
    q = quat_slerp(rot0, rot1, alpha)
    return {"point": se3pose_transform_point(t, q, point),
            "out_of_bounds": _out_of_bounds(time0, time1, query_time)}


def trajectory_transform_point_1pose(trans, rot, time, point, query_time) -> Dict[str, Tensor]:
    """Single-keyframe trajectory: the pose is constant in time."""
    del time, query_time  # a single keyframe is valid for all times
    return {"point": se3pose_transform_point(trans, rot, point),
            "out_of_bounds": torch.zeros(point.shape[:-1], dtype=torch.bool,
                                         device=point.device)}


def se3_interpolate_tracks(
    pose_translations: Tensor,  # [M, 3]
    pose_rotations: Tensor,  # [M, 4] xyzw
    pose_times: Tensor,  # [M]
    pose_offsets: Tensor,  # [C]
    pose_counts: Tensor,  # [C]
    query_time: Union[float, Tensor],
) -> Tuple[Tensor, Tensor]:
    """Packed SE(3) keyframe tracks interpolated at query times: per track,
    the last keyframe at or before the time within its range, translations
    lerped and rotations slerped, clamped outside the track's span."""
    M = pose_times.shape[0]
    C = pose_offsets.shape[0]
    off = pose_offsets.reshape(C).long()
    cnt = pose_counts.reshape(C).long()
    times = pose_times.reshape(M)
    qt = torch.as_tensor(query_time, dtype=times.dtype, device=times.device).expand(C)
    ar = torch.arange(M, device=times.device)
    idxs = off[:, None] + ar[None]
    t = torch.where(ar[None] < cnt[:, None], times[torch.clamp(idxs, max=M - 1)], float("inf"))
    hi = (t <= qt[:, None]).sum(-1)
    i1 = torch.minimum(torch.clamp(hi, min=1), torch.clamp(cnt - 1, min=1))
    k0 = off + i1 - 1
    k1 = off + torch.minimum(i1, cnt - 1)
    t0, t1 = times[k0], times[k1]
    span = t1 - t0
    a = torch.where(span == 0, 0.0, (qt - t0) / torch.where(span == 0, 1.0, span))
    a = torch.clamp(a, 0.0, 1.0)
    tr = pose_translations[k0] + (pose_translations[k1] - pose_translations[k0]) * a[:, None]
    return tr, quat_slerp(pose_rotations[k0], pose_rotations[k1], a)
