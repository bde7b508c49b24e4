"""Port parity: every function of gsplat_tpu/geometry/functional.py (xyzw
quaternions, SE(3) poses, trajectories, se3_interpolate_tracks), and
quat_multiply, world_to_cam, proj (pinhole, ortho, fisheye),
compact_visible and fully_fused_projection_packed, against the JAX
package on the same seeded inputs.

Tolerances: 2e-6 absolute on unit-scale outputs (float32 rounding of the
same elementwise formulas; sums of three products may round in another
order than XLA's dot), 1e-5 relative on projected pixels and covariances;
ids, counts, masks, radii and indptr exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.geometry import functional as jg
from gsplat_tpu.ops import math as jm
from gsplat_tpu.ops import projection as jp
from gsplat_tpu.ops import projection_packed as jpk
from gsplat_tpu_torch.geometry import functional as tg
from gsplat_tpu_torch.ops import math as tm
from gsplat_tpu_torch.ops import projection as tp
from gsplat_tpu_torch.ops import projection_packed as tpk

RNG = np.random.default_rng(11)
N = 64
Q1 = RNG.standard_normal((N, 4)).astype(np.float32)
Q2 = RNG.standard_normal((N, 4)).astype(np.float32)
Q2[:4] = Q1[:4] * 1.0000001  # nearly parallel: the lerp branch
Q2[4:8] = -Q1[4:8]  # the far side: the short arc
Q1[8] = 0.0  # a zero quaternion: the identity fallback
V = RNG.standard_normal((N, 3)).astype(np.float32)
T1 = RNG.standard_normal((N, 3)).astype(np.float32)
T2 = RNG.standard_normal((N, 3)).astype(np.float32)
TT = RNG.uniform(0.0, 1.0, N).astype(np.float32)
TIME0 = RNG.uniform(0.0, 1.0, N).astype(np.float32)
TIME1 = TIME0 + RNG.uniform(0.0, 1.0, N).astype(np.float32)
TIME1[:3] = TIME0[:3]  # a zero span
QT = RNG.uniform(-0.5, 2.5, N).astype(np.float32)


def _check(got, want, tol=2e-6):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _check(got[k], want[k], tol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _check(a, b, tol)
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


CASES = {
    "quat_normalize_safe": (Q1,),
    "quat_conjugate": (Q1,),
    "quat_inverse": (Q1,),
    "quat_multiply": (Q1, Q2),
    "quat_rotate_vector": (Q1, V),
    "quat_from_axis_angle": (V, TT * 3.0),
    "quat_to_matrix": (Q1,),
    "quat_angular_distance": (Q1, Q2),
    "quat_lerp": (Q1, Q2, TT),
    "quat_slerp": (Q1, Q2, TT),
    "quat_manifold_interp": (Q1, Q2, TT),
    "se3pose_compose": (T1, Q1, T2, Q2),
    "se3pose_transform_point": (T1, Q1, V),
    "se3pose_transform_direction": (T1, Q1, V),
    "se3pose_inverse_transform_point": (T1, Q1, V),
    "se3pose_inverse_transform_direction": (T1, Q1, V),
    "se3pose_to_matrix": (T1, Q1),
    "se3pose_to_inverse_matrix": (T1, Q1),
    "trajectory_get_rotation_2poses": (T1, Q1, TIME0, T2, Q2, TIME1, QT),
    "trajectory_transform_point_2poses": (T1, Q1, TIME0, T2, Q2, TIME1, V, QT),
    "trajectory_transform_point_1pose": (T1, Q1, TIME0, V, QT),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_function_matches_jax(name):
    args = CASES[name]
    want = getattr(jg, name)(*map(jnp.asarray, args))
    got = getattr(tg, name)(*map(torch.from_numpy, args))
    # arccos at 1 has an infinite slope: one float32 ulp of the dot of two
    # nearly parallel quaternions moves the angle by 6.9e-4; the manifold
    # interp's log and the slerp's sin ratio amplify ulps less
    tol = {"quat_angular_distance": 1e-3, "quat_manifold_interp": 2e-5}.get(name, 2e-6)
    _check(got, want, tol)


def test_quat_identity_and_scalar_times():
    _check(tg.quat_identity((3, 2)), jg.quat_identity((3, 2)))
    _check(tg.quat_slerp(torch.from_numpy(Q1), torch.from_numpy(Q2), 0.25),
           jg.quat_slerp(jnp.asarray(Q1), jnp.asarray(Q2), 0.25))
    _check(tg.quat_lerp(torch.from_numpy(Q1), torch.from_numpy(Q2), 0.7),
           jg.quat_lerp(jnp.asarray(Q1), jnp.asarray(Q2), 0.7))


def test_se3pose_from_matrix_and_frame_transform():
    M = np.array(jg.se3pose_to_matrix(jnp.asarray(T1), jnp.asarray(Q1)))
    _check(tg.se3pose_from_matrix(torch.from_numpy(M)), jg.se3pose_from_matrix(jnp.asarray(M)))
    rot, tr = (0.1, -0.2, 0.3, 0.9), (1.0, -2.0, 0.5)
    _check(tg.frame_transform_poses_tquat(torch.from_numpy(T1), torch.from_numpy(Q1), rot, tr),
           jg.frame_transform_poses_tquat(jnp.asarray(T1), jnp.asarray(Q1), rot, tr))


def test_se3_interpolate_tracks():
    counts = np.array([5, 1, 3, 7], np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    M = int(counts.sum())
    rng = np.random.default_rng(4)
    times = np.concatenate([np.sort(rng.uniform(0, 1, c)) for c in counts]).astype(np.float32)
    times[offsets[2] + 1] = times[offsets[2]]  # a repeated keyframe time
    trans = rng.standard_normal((M, 3)).astype(np.float32)
    rots = rng.standard_normal((M, 4)).astype(np.float32)
    for q in (-0.1, 0.37, 0.5, 1.3):
        args = (trans, rots, times, offsets, counts)
        _check(tg.se3_interpolate_tracks(*map(torch.from_numpy, args), q),
               jg.se3_interpolate_tracks(*map(jnp.asarray, args), q))
    qs = np.array([0.1, 0.9, 0.5, 0.0], np.float32)
    _check(tg.se3_interpolate_tracks(*map(torch.from_numpy, args), torch.from_numpy(qs)),
           jg.se3_interpolate_tracks(*map(jnp.asarray, args), jnp.asarray(qs)))


def test_ops_math_quat_multiply_and_world_to_cam():
    _check(tm.quat_multiply(torch.from_numpy(Q1), torch.from_numpy(Q2)),
           jm.quat_multiply(jnp.asarray(Q1), jnp.asarray(Q2)))
    rng = np.random.default_rng(6)
    means = rng.standard_normal((2, 30, 3)).astype(np.float32)
    L = rng.standard_normal((2, 30, 3, 3)).astype(np.float32)
    covars = L @ L.transpose(0, 1, 3, 2)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    viewmats[..., :3, :3] = np.asarray(jm.quat_to_rotmat(jnp.asarray(
        rng.standard_normal((2, 3, 4)).astype(np.float32))))
    viewmats[..., :3, 3] = rng.standard_normal((2, 3, 3))
    args = (means, covars, viewmats)
    _check(tm.world_to_cam(*map(torch.from_numpy, args)), jm.world_to_cam(*map(jnp.asarray, args)))


def _camera_frame(seed, C=2, n=40):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (C, n, 3)).astype(np.float32)
    means[..., 2] = rng.uniform(1.0, 6.0, (C, n))
    L = rng.standard_normal((C, n, 3, 3)).astype(np.float32) * 0.1
    covars = (L @ L.transpose(0, 1, 3, 2)).astype(np.float32)
    Ks = np.array([[[80.0, 0, 32.0], [0, 70.0, 24.0], [0, 0, 1]]] * C, np.float32)
    return means, covars, Ks


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
def test_proj_matches_jax(camera_model):
    means, covars, Ks = _camera_frame(7)
    want = jp.proj(jnp.asarray(means), jnp.asarray(covars), jnp.asarray(Ks), 64, 48, camera_model)
    got = tp.proj(torch.from_numpy(means), torch.from_numpy(covars), torch.from_numpy(Ks), 64, 48,
                  camera_model)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    with pytest.raises(ValueError):
        tp.proj(torch.from_numpy(means), torch.from_numpy(covars), torch.from_numpy(Ks), 64, 48,
                "lidar")


def _gaussians(seed, n=120):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-1.0, 6.0, n)  # some behind the camera
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    viewmats[1, :3, 3] = [0.3, -0.1, 0.5]
    Ks = np.array([[[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]]] * 2, np.float32)
    return means, quats, scales, opac, viewmats, Ks


def test_compact_visible_matches_jax():
    rng = np.random.default_rng(9)
    valid = rng.random((3, 50)) > 0.6
    arrays = [rng.standard_normal((3, 50, 2)).astype(np.float32),
              rng.integers(0, 9, (3, 50)).astype(np.int32)]
    for cap in (200, 40, 150):
        want = jpk.compact_visible(jnp.asarray(valid), [jnp.asarray(a) for a in arrays], cap)
        got = tpk.compact_visible(torch.from_numpy(valid), [torch.from_numpy(a) for a in arrays],
                                  cap)
        cam, gid, outs, sel, nnz, over, indptr = got
        for a, b in zip((cam, gid, sel, nnz, over, indptr), (want[0], want[1], *want[3:])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(outs, want[2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("comp,cap", [(False, 240), (True, 240), (True, 100)])
def test_fully_fused_projection_packed_matches_jax(comp, cap):
    means, quats, scales, opac, viewmats, Ks = _gaussians(12)
    kw = dict(calc_compensations=comp, near_plane=0.2, opacities=None)
    want = jpk.fully_fused_projection_packed(*map(jnp.asarray, (means, None, quats, scales)[:1]),
                                             None, *map(jnp.asarray, (quats, scales, viewmats, Ks)),
                                             64, 48, cap, **kw)
    got = tpk.fully_fused_projection_packed(torch.from_numpy(means), None,
                                            *map(torch.from_numpy, (quats, scales, viewmats, Ks)),
                                            64, 48, cap, **kw)
    assert set(got) == set(want)
    for k, b in want.items():
        a = got[k]
        if b is None:
            assert a is None, k
            continue
        b = np.asarray(b)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * max(1, np.abs(b).max()),
                                       err_msg=k)
    assert int(got["nnz"]) > 100 and bool(got["overflow"]) == (cap == 100)
