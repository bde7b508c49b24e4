"""Camera models: perfect and OpenCV pinhole, orthographic, OpenCV fisheye and
f-theta, both ways, with rolling-shutter pose interpolation.

Port of `gsplat_tpu/sensors/cameras.py`.  One frozen parameter record
(`CameraModel`, built by `make_camera`) and plain functions on tensors,
differentiable by autograd: rays carry gradient back to the poses and so to
`viewmats`.  The inverse models run Newton iterations of fixed count and
freeze the lanes that have converged (`CameraLinearParams`: 20 for the
polynomial inverses, 3 for f-theta, 5 for the OpenCV undistortion), as the
JAX package does, so rays agree with it to rounding.

Shapes: camera parameters carry batch dimensions [..., C, k]; point
arguments add one trailing point axis, [..., C, M, k].  Poses are 7-vectors
[tx, ty, tz, qw, qx, qy, qz] (wxyz quaternions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops.math import quat_inverse, quat_rotate, quat_slerp, rotmat_to_quat
from .params import (
    CameraLinearParams,
    FThetaCameraDistortionParameters,
    FThetaPolynomialType,
    RollingShutterType,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Small numerics helpers
# ---------------------------------------------------------------------------


def _safe_normalize(v: Tensor, dim: int = -1) -> Tensor:
    """v / |v| where |v| > 0, else v."""
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    return torch.where(n > 0.0, v / torch.where(n > 0.0, n, 1.0), v)


def _stable_norm2(x: Tensor, y: Tensor) -> Tensor:
    """sqrt(x^2 + y^2), computed scale-invariantly."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    r = lo / torch.where(hi > 0.0, hi, 1.0)
    return hi * torch.sqrt(1.0 + r * r)


def eval_poly_full(coeffs: Tensor, x: Tensor) -> Tensor:
    """Horner evaluation of c0 + c1 x + ...; `coeffs[..., i]` broadcasts
    against x (pass coeffs[..., None, :] for a point axis)."""
    k = coeffs.shape[-1]
    r = coeffs[..., k - 1]
    for i in range(k - 2, -1, -1):
        r = r * x + coeffs[..., i]
    return r


def eval_poly_odd(coeffs: Tensor, x: Tensor) -> Tensor:
    """c0 x + c1 x^3 + c2 x^5 + ..."""
    return x * eval_poly_full(coeffs, x * x)


def eval_poly_even(coeffs: Tensor, x: Tensor) -> Tensor:
    """c0 + c1 x^2 + c2 x^4 + ..."""
    return eval_poly_full(coeffs, x * x)


def poly_inverse_newton(f, df, x0: Tensor, y: Tensor, n_iterations: int,
                        tol: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """Solve f(x) = y by Newton from x0 in a fixed number of iterations;
    a lane whose step fell below `tol` is frozen from the next iteration on.
    Returns (x, converged)."""
    x = x0
    converged = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for _ in range(n_iterations):
        dx = (f(x) - y) / df(x)
        x = torch.where(converged, x, x - dx)
        converged = converged | (torch.abs(dx) < tol)
    return x, converged


# ---------------------------------------------------------------------------
# Poses (7-vectors [t, q_wxyz])
# ---------------------------------------------------------------------------


def viewmat_to_pose(viewmat: Tensor) -> Tensor:
    """4x4 world-to-camera matrices -> 7D poses."""
    return torch.cat([viewmat[..., :3, 3], rotmat_to_quat(viewmat[..., :3, :3])], dim=-1)


def pose_camera_world_position(pose: Tensor) -> Tensor:
    """The camera centre in world coordinates: R^-1 (-t)."""
    return quat_rotate(quat_inverse(pose[..., 3:]), -pose[..., :3])


def pose_world_points_to_camera_ray(pose: Tensor, world_points: Tensor) -> Tensor:
    """p_cam = R p_world + t."""
    return quat_rotate(pose[..., 3:], world_points) + pose[..., :3]


def pose_camera_ray_to_world_ray(pose: Tensor, camera_ray: Tensor) -> Tuple[Tensor, Tensor]:
    """(origin, direction) of camera-frame rays in world coordinates."""
    q_inv = quat_inverse(pose[..., 3:])
    return quat_rotate(q_inv, -pose[..., :3]), quat_rotate(q_inv, camera_ray)


def interpolate_shutter_pose(pose_start: Tensor, pose_end: Tensor, relative_time: Tensor) -> Tensor:
    """Translation by lerp, rotation by slerp, at `relative_time` in [0, 1]."""
    a = relative_time[..., None]
    t = (1.0 - a) * pose_start[..., :3] + a * pose_end[..., :3]
    q = quat_slerp(pose_start[..., 3:], pose_end[..., 3:], a)
    return torch.cat([t, _safe_normalize(q)], dim=-1)


# ---------------------------------------------------------------------------
# Camera parameter record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Parameters of one batched camera model; `kind` selects the
    projection.  Per-camera tensors are [..., C, k].  Built by `make_camera`,
    which precomputes the fisheye maximum angle and the f-theta derivative
    polynomial."""

    kind: str  # pinhole | opencv_pinhole | ortho | fisheye | ftheta
    width: int
    height: int
    shutter_type: RollingShutterType
    focal_lengths: Tensor  # [..., C, 2]
    principal_points: Tensor  # [..., C, 2]
    # OpenCV pinhole
    radial_coeffs: Optional[Tensor] = None  # [..., C, 6]
    tangential_coeffs: Optional[Tensor] = None  # [..., C, 2]
    thin_prism_coeffs: Optional[Tensor] = None  # [..., C, 4]
    # fisheye (precomputed)
    fisheye_fwd_poly: Optional[Tensor] = None  # [..., C, 5] odd in theta
    fisheye_dfwd_poly: Optional[Tensor] = None  # [..., C, 5] even in theta
    fisheye_approx_bwd: Optional[Tensor] = None  # [..., C, 2] full in delta
    max_angle: Optional[Tensor] = None  # [..., C] (fisheye and f-theta)
    # f-theta (precomputed)
    ftheta_reference_poly: Optional[FThetaPolynomialType] = None
    ftheta_linear_cde: Optional[Tensor] = None  # [..., C, 3]
    ftheta_p2a: Optional[Tensor] = None  # [..., C, 6]
    ftheta_a2p: Optional[Tensor] = None  # [..., C, 6]
    ftheta_dref: Optional[Tensor] = None  # [..., C, 5]
    # a ray-space warp before (forward) or after (inverse) the base model
    # (sensors/external.py, the windshield model)
    external_distortion: Optional[object] = None
    opts: CameraLinearParams = CameraLinearParams()


def _smallest_positive_root_1_axx3(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """The smallest positive root of 1 + a x + b x^2 + c x^3, else +inf: every
    case evaluated and composed by select."""
    inf = torch.full_like(a, math.inf)
    is_c_zero = torch.abs(c) < 1e-10
    is_linear = is_c_zero & (torch.abs(b) < 1e-10)
    a_safe = torch.where(torch.abs(a) > 0, a, 1.0)
    linear_result = torch.where(a >= 0.0, inf, -1.0 / a_safe)

    delta_quad = a * a - 4.0 * b
    has_quad = is_c_zero & ~is_linear & (delta_quad >= 0.0)
    delta_term = torch.sqrt(torch.clamp(delta_quad, min=0.0)) - a
    quad_result = torch.where(delta_term > 0.0,
                              2.0 / torch.where(delta_term != 0, delta_term, 1.0), inf)

    c_safe = torch.where(is_c_zero, 1.0, c)
    boc = b / c_safe
    boc2 = boc * boc
    t1 = (9.0 * a * boc - 2.0 * b * boc2 - 27.0) / c_safe
    t2 = 3.0 * a / c_safe - boc2
    delta_cubic = t1 * t1 + 4.0 * t2 * t2 * t2

    has_real_root = ~is_c_zero & (delta_cubic >= 0.0)
    d2 = torch.sqrt(torch.clamp(delta_cubic, min=0.0))
    half = (d2 + t1) / 2.0
    cube_root = torch.sign(half) * torch.abs(half) ** (1.0 / 3.0)
    cr_safe = torch.where(cube_root != 0, cube_root, 1.0)
    real_root = torch.where(cube_root != 0, (cube_root - t2 / cr_safe - boc) / 3.0, inf)
    real_root = torch.where(real_root > 0.0, real_root, inf)

    theta = torch.atan2(torch.sqrt(torch.clamp(-delta_cubic, min=0.0)), t1) / 3.0
    t3 = 2.0 * torch.sqrt(torch.clamp(-t2, min=0.0))
    soln = inf
    for i in (-1, 0, 1):
        s = (t3 * torch.cos(theta + i * (2.0 * math.pi / 3.0)) - boc) / 3.0
        soln = torch.minimum(soln, torch.where(s > 0.0, s, inf))

    return torch.where(
        is_linear, linear_result,
        torch.where(has_quad, quad_result,
                    torch.where(has_real_root, real_root, torch.where(~is_c_zero, soln, inf))))


def _f32(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def make_camera(
    camera_model: str,
    width: int = 0,
    height: int = 0,
    focal_lengths: Optional[Tensor] = None,  # [..., C, 2]
    principal_points: Optional[Tensor] = None,  # [..., C, 2]
    radial_coeffs: Optional[Tensor] = None,  # [..., C, <=6]; fisheye [..., C, 4]
    tangential_coeffs: Optional[Tensor] = None,  # [..., C, 2]
    thin_prism_coeffs: Optional[Tensor] = None,  # [..., C, 4]
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    shutter_type: RollingShutterType = RollingShutterType.GLOBAL,
    opts: CameraLinearParams = CameraLinearParams(),
    lidar_coeffs=None,
    external_distortion=None,
):
    """Build a `CameraModel`.  A pinhole with any distortion coefficient
    becomes `opencv_pinhole`; camera_model="lidar" returns `lidar_coeffs`
    (a sensors.lidars.LidarModel) as it is."""
    if camera_model == "lidar":
        if lidar_coeffs is None:
            raise ValueError("camera_model='lidar' requires lidar_coeffs")
        return lidar_coeffs
    if principal_points is None:
        raise ValueError("make_camera needs principal_points")
    pp = torch.as_tensor(principal_points, dtype=torch.float32)
    B = tuple(pp.shape[:-1])

    def zeros(k):
        return torch.zeros(B + (k,), dtype=pp.dtype, device=pp.device)

    if camera_model in ("pinhole", "ortho", "fisheye") and focal_lengths is None:
        raise ValueError(f"camera_model={camera_model!r} needs focal_lengths")

    if camera_model == "pinhole":
        fl = _f32(focal_lengths, pp)
        if radial_coeffs is None and tangential_coeffs is None and thin_prism_coeffs is None:
            return CameraModel("pinhole", width, height, shutter_type, fl, pp,
                               external_distortion=external_distortion, opts=opts)
        rad = zeros(6)
        if radial_coeffs is not None:
            rc = _f32(radial_coeffs, pp)
            rad = torch.cat([rc, rad[..., rc.shape[-1]:]], dim=-1)
        tan = _f32(tangential_coeffs, pp) if tangential_coeffs is not None else zeros(2)
        tp = _f32(thin_prism_coeffs, pp) if thin_prism_coeffs is not None else zeros(4)
        return CameraModel("opencv_pinhole", width, height, shutter_type, fl, pp,
                           radial_coeffs=rad, tangential_coeffs=tan, thin_prism_coeffs=tp,
                           external_distortion=external_distortion, opts=opts)

    if camera_model == "ortho":
        return CameraModel("ortho", width, height, shutter_type, _f32(focal_lengths, pp), pp,
                           external_distortion=external_distortion, opts=opts)

    if camera_model == "fisheye":
        fl = _f32(focal_lengths, pp)
        k = _f32(radial_coeffs, pp) if radial_coeffs is not None else zeros(4)
        k1, k2, k3, k4 = k.unbind(-1)
        one = torch.ones_like(k1)
        fwd = torch.stack([one, k1, k2, k3, k4], dim=-1)
        dfwd = torch.stack([one, 3 * k1, 5 * k2, 7 * k3, 9 * k4], dim=-1)

        fx, fy = fl[..., 0], fl[..., 1]
        cx, cy = pp[..., 0], pp[..., 1]
        mdx = torch.maximum(width - cx, cx)
        mdy = torch.maximum(height - cy, cy)
        max_radius_px = torch.sqrt(mdx * mdx + mdy * mdy)

        # the maximum angle: where the derivative polynomial reaches zero
        k4_zero = torch.abs(k4) < 1e-10
        ang_k4z = torch.sqrt(torch.clamp(
            _smallest_positive_root_1_axx3(3.0 * k1, 5.0 * k2, 7.0 * k3), min=0.0))
        ddfwd = torch.stack([6 * k1, 20 * k2, 42 * k3, 72 * k4], dim=-1)
        ang_nz, conv = poly_inverse_newton(
            lambda x: eval_poly_even(dfwd, x), lambda x: eval_poly_odd(ddfwd, x),
            torch.full_like(k1, 1.57), torch.zeros_like(k1), n_iterations=opts.newton_iterations)
        ang_nz = torch.where(conv & (ang_nz > 0.0), ang_nz, math.inf)
        max_angle = torch.where(k4_zero, ang_k4z, ang_nz)
        max_angle = torch.minimum(max_angle,
                                  torch.maximum(max_radius_px / fx, max_radius_px / fy))

        max_norm_dist = torch.maximum(width / 2.0 / fx, height / 2.0 / fy)
        approx_bwd = torch.stack([torch.zeros_like(max_angle), max_angle / max_norm_dist], dim=-1)
        return CameraModel("fisheye", width, height, shutter_type, fl, pp, radial_coeffs=k,
                           fisheye_fwd_poly=fwd, fisheye_dfwd_poly=dfwd,
                           fisheye_approx_bwd=approx_bwd, max_angle=max_angle,
                           external_distortion=external_distortion, opts=opts)

    if camera_model == "ftheta":
        if ftheta_coeffs is None:
            raise ValueError("camera_model='ftheta' requires ftheta_coeffs")
        ft = ftheta_coeffs
        pp = pp + 0.5  # the image origin is the first pixel's centre

        def table(vals, k):
            return _f32(vals, pp).expand(B + (k,))

        p2a = table(ft.pixeldist_to_angle_poly, 6)
        a2p = table(ft.angle_to_pixeldist_poly, 6)
        cde = table(ft.linear_cde, 3)
        p2a_ref = ft.reference_poly == FThetaPolynomialType.PIXELDIST_TO_ANGLE
        ref = p2a if p2a_ref else a2p
        dref = ref[..., 1:] * torch.arange(1.0, 6.0, dtype=pp.dtype, device=pp.device)
        f = 1.0 / p2a[..., 1] if p2a_ref else a2p[..., 1]  # the focal length's proxy
        fl = torch.stack([f, f], dim=-1)
        max_angle = _f32(ft.max_angle, pp).expand(B)
        return CameraModel("ftheta", width, height, shutter_type, fl, pp,
                           ftheta_reference_poly=ft.reference_poly, ftheta_linear_cde=cde,
                           ftheta_p2a=p2a, ftheta_a2p=a2p, ftheta_dref=dref,
                           max_angle=max_angle, external_distortion=external_distortion,
                           opts=dataclasses.replace(opts, newton_iterations=3))

    raise ValueError(f"unsupported camera model: {camera_model!r}")


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def check_image_bounds(cam: CameraModel, points_2d: Tensor, margin_factor: float) -> Tensor:
    """In-image test with a margin relative to the image size."""
    u, v = points_2d[..., 0], points_2d[..., 1]
    mx = cam.width * margin_factor
    my = cam.height * margin_factor
    return (u >= -mx) & (u < cam.width + mx) & (v >= -my) & (v < cam.height + my)


def shutter_relative_frame_time(cam: CameraModel, pixel_coords: Tensor) -> Tensor:
    """Each pixel's shutter time in [0, 1]."""
    if cam.kind == "lidar":
        from .lidars import lidar_shutter_relative_frame_time

        return lidar_shutter_relative_frame_time(cam, pixel_coords)
    st = cam.shutter_type
    px, py = pixel_coords[..., 0], pixel_coords[..., 1]
    if st == RollingShutterType.GLOBAL:
        return torch.zeros_like(px)
    if st == RollingShutterType.ROLLING_TOP_TO_BOTTOM:
        return torch.floor(py) / float(cam.height - 1) if cam.height > 1 else torch.full_like(py, 0.5)
    if st == RollingShutterType.ROLLING_LEFT_TO_RIGHT:
        return torch.floor(px) / float(cam.width - 1) if cam.width > 1 else torch.full_like(px, 0.5)
    if st == RollingShutterType.ROLLING_BOTTOM_TO_TOP:
        return ((cam.height - torch.ceil(py)) / float(cam.height - 1) if cam.height > 1
                else torch.full_like(py, 0.5))
    if st != RollingShutterType.ROLLING_RIGHT_TO_LEFT:
        raise ValueError(f"unknown shutter type {st!r}")
    return ((cam.width - torch.ceil(px)) / float(cam.width - 1) if cam.width > 1
            else torch.full_like(px, 0.5))


def _fl_pp(cam: CameraModel) -> Tuple[Tensor, Tensor]:
    """Focal lengths and principal points broadcast over one point axis."""
    return cam.focal_lengths[..., None, :], cam.principal_points[..., None, :]


def _opencv_distortion(cam: CameraModel, uv: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(icD, delta, r2) of the rational + tangential + thin-prism model."""
    k = cam.radial_coeffs[..., None, :]  # [..., C, 1, 6]
    p = cam.tangential_coeffs[..., None, :]
    s = cam.thin_prism_coeffs[..., None, :]
    u, v = uv[..., 0], uv[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    a1 = 2.0 * u * v
    a2 = r2 + 2.0 * u2
    a3 = r2 + 2.0 * v2
    num = 1.0 + r2 * (k[..., 0] + r2 * (k[..., 1] + r2 * k[..., 2]))
    den = 1.0 + r2 * (k[..., 3] + r2 * (k[..., 4] + r2 * k[..., 5]))
    icD = num / den
    dx = p[..., 0] * a1 + p[..., 1] * a2 + r2 * (s[..., 0] + r2 * s[..., 1])
    dy = p[..., 0] * a3 + p[..., 1] * a1 + r2 * (s[..., 2] + r2 * s[..., 3])
    return icD, torch.stack([dx, dy], dim=-1), r2


# ---------------------------------------------------------------------------
# camera_ray_to_image_point
# ---------------------------------------------------------------------------


def camera_ray_to_image_point(cam: CameraModel, cam_ray: Tensor,
                              margin_factor: float) -> Tuple[Tensor, Tensor]:
    """Project camera-frame rays or points [..., C, M, 3] to pixels.

    Returns (image_point [..., C, M, 2], valid [..., C, M]).
    """
    if cam.kind == "lidar":
        from .lidars import lidar_ray_to_image_point

        return lidar_ray_to_image_point(cam, cam_ray, margin_factor)
    if cam.external_distortion is not None:
        from .external import apply_external_distortion

        cam_ray = apply_external_distortion(cam.external_distortion, cam_ray)
    fl, pp = _fl_pp(cam)
    z = cam_ray[..., 2]

    if cam.kind in ("pinhole", "opencv_pinhole"):
        valid_depth = z > 0.0
        uv = cam_ray[..., :2] / cam_ray[..., 2:3]
        if cam.kind == "opencv_pinhole":
            icD, delta, _ = _opencv_distortion(cam, uv)
            pt = (icD[..., None] * uv + delta) * fl + pp
            # the OpenCV model keeps the coordinates of invalid points
            valid = valid_depth & (icD > 0.8) & check_image_bounds(cam, pt, margin_factor)
            return pt, valid
        pt = torch.where(valid_depth[..., None], uv * fl + pp, 0.0)
        return pt, valid_depth & check_image_bounds(cam, pt, margin_factor)

    if cam.kind == "ortho":
        valid_depth = z > 0.0
        pt = torch.where(valid_depth[..., None], cam_ray[..., :2] * fl + pp, 0.0)
        return pt, valid_depth & check_image_bounds(cam, pt, margin_factor)

    if cam.kind in ("fisheye", "ftheta"):
        xy_norm = _stable_norm2(cam_ray[..., 0], cam_ray[..., 1])
        xy_norm = torch.where(xy_norm <= 0.0, torch.finfo(cam_ray.dtype).eps, xy_norm)
        theta_full = torch.atan2(xy_norm, z)
        ma = cam.max_angle[..., None]
        theta = torch.minimum(theta_full, ma)

    if cam.kind == "fisheye":
        delta = eval_poly_odd(cam.fisheye_fwd_poly[..., None, :], theta) / xy_norm
        pt = delta[..., None] * cam_ray[..., :2] * fl + pp
        valid = ((z > 0.0) & (delta > 0.0) & (theta_full < ma)
                 & check_image_bounds(cam, pt, margin_factor))
        return pt, valid

    if cam.kind == "ftheta":
        not_behind = z > 0.0
        a2p = cam.ftheta_a2p[..., None, :]
        p2a = cam.ftheta_p2a[..., None, :]
        dref = cam.ftheta_dref[..., None, :]
        if cam.ftheta_reference_poly == FThetaPolynomialType.PIXELDIST_TO_ANGLE:
            # the forward by Newton inversion of the reference; its
            # convergence flag is advisory, delta is used as it is
            delta, _ = poly_inverse_newton(
                lambda x: eval_poly_full(p2a, x), lambda x: eval_poly_full(dref, x),
                eval_poly_full(a2p, theta), theta, n_iterations=cam.opts.newton_iterations)
        else:
            delta = eval_poly_full(a2p, theta)
        ix = delta * cam_ray[..., 0] / xy_norm
        iy = delta * cam_ray[..., 1] / xy_norm
        cde = cam.ftheta_linear_cde[..., None, :]
        c, d, e = cde[..., 0], cde[..., 1], cde[..., 2]
        pt = torch.stack([c * ix + d * iy + pp[..., 0], e * ix + iy + pp[..., 1]], dim=-1)
        valid = not_behind & (theta_full < ma) & check_image_bounds(cam, pt, margin_factor)
        return pt * not_behind[..., None], valid

    raise ValueError(f"unsupported camera kind: {cam.kind!r}")


# ---------------------------------------------------------------------------
# image_point_to_camera_ray
# ---------------------------------------------------------------------------


def _opencv_undistort_newton(cam: CameraModel, uv0: Tensor) -> Tuple[Tensor, Tensor]:
    """Newton-Raphson undistortion in `max_undistortion_iterations` steps;
    converged and invalid lanes are frozen."""
    k = cam.radial_coeffs[..., None, :]
    p = cam.tangential_coeffs[..., None, :]
    s = cam.thin_prism_coeffs[..., None, :]
    eps = 1e-6
    xd, yd = uv0[..., 0], uv0[..., 1]
    p1, p2 = p[..., 0], p[..., 1]
    s1, s2, s3, s4 = (s[..., i] for i in range(4))

    def res_jac(xy):
        x, y = xy[..., 0], xy[..., 1]
        r = x * x + y * y
        r2 = r * r
        alpha = 1.0 + r * (k[..., 0] + r * (k[..., 1] + r * k[..., 2]))
        beta = 1.0 + r * (k[..., 3] + r * (k[..., 4] + r * k[..., 5]))
        d = alpha / beta
        valid = d > 0.0
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) + s1 * r + s2 * r2 - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) + s3 * r + s4 * r2 - yd
        alpha_r = k[..., 0] + r * (2.0 * k[..., 1] + r * (3.0 * k[..., 2]))
        beta_r = k[..., 3] + r * (2.0 * k[..., 4] + r * (3.0 * k[..., 5]))
        d_r = (alpha_r * beta - alpha * beta_r) / (beta * beta)
        d_x, d_y = 2.0 * x * d_r, 2.0 * y * d_r
        fx_x = d + d_x * x + 2 * p1 * y + 6 * p2 * x + 2 * x * (s1 + 2 * s2 * r)
        fx_y = d_y * x + 2 * p1 * x + 2 * p2 * y + 2 * y * (s1 + 2 * s2 * r)
        fy_x = d_x * y + 2 * p2 * y + 2 * p1 * x + 2 * x * (s3 + 2 * s4 * r)
        fy_y = d + d_y * y + 2 * p2 * x + 6 * p1 * y + 2 * y * (s3 + 2 * s4 * r)
        return tuple(torch.where(valid, t, 0.0) for t in (fx, fy, fx_x, fx_y, fy_x, fy_y)) + (valid,)

    uv_hat = uv0
    converged = torch.zeros(uv0.shape[:-1], dtype=torch.bool, device=uv0.device)
    valid_points = torch.ones_like(converged)
    for _ in range(cam.opts.max_undistortion_iterations):
        fx, fy, fxx, fxy, fyx, fyy, valid_jac = res_jac(uv_hat)
        valid_points = valid_points & valid_jac
        det = fxx * fyy - fxy * fyx
        valid_points = valid_points & (torch.abs(det) >= eps)
        det_safe = torch.where(torch.abs(det) >= eps, det, 1.0)
        step = -torch.stack([(fx * fyy - fy * fxy) / det_safe,
                             (fy * fxx - fx * fyx) / det_safe], dim=-1)
        frozen = converged | ~valid_points
        uv_hat = torch.where(frozen[..., None], uv_hat, uv_hat + step)
        step_conv = (torch.abs(step[..., 0]) < eps) & (torch.abs(step[..., 1]) < eps)
        converged = converged | (valid_points & step_conv)
    return uv_hat, converged


def image_point_to_camera_ray(cam: CameraModel, image_point: Tensor) -> Tuple[Tensor, Tensor]:
    """Unproject pixels [..., C, M, 2] to unit camera rays [..., C, M, 3];
    returns (rays, valid)."""
    if cam.kind == "lidar":
        from .lidars import lidar_image_point_to_ray

        return lidar_image_point_to_ray(cam, image_point)
    ray, valid = _image_point_to_camera_ray_base(cam, image_point)
    if cam.external_distortion is not None:
        from .external import apply_external_distortion

        ray = apply_external_distortion(cam.external_distortion, ray, inverse=True)
    return ray, valid


def _straight_or(mask: Tensor, theta: Tensor, uv: Tensor, delta_safe: Tensor) -> Tensor:
    """The ray at angle theta from the axis through uv, or (0, 0, 1) where
    `mask` holds."""
    sf = torch.sin(theta) / delta_safe
    ray = torch.stack([sf * uv[..., 0], sf * uv[..., 1], torch.cos(theta)], dim=-1)
    straight = torch.stack([torch.zeros_like(theta), torch.zeros_like(theta),
                            torch.ones_like(theta)], dim=-1)
    return torch.where(mask[..., None], straight, ray)


def _image_point_to_camera_ray_base(cam: CameraModel, image_point: Tensor) -> Tuple[Tensor, Tensor]:
    fl, pp = _fl_pp(cam)
    all_valid = torch.ones(image_point.shape[:-1], dtype=torch.bool, device=image_point.device)

    if cam.kind == "pinhole":
        uv = (image_point - pp) / fl
        return _safe_normalize(torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)), all_valid

    if cam.kind == "opencv_pinhole":
        uv, converged = _opencv_undistort_newton(cam, (image_point - pp) / fl)
        return _safe_normalize(torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)), converged

    if cam.kind == "ortho":
        z = torch.zeros_like(image_point[..., :1])
        return torch.cat([z, z, torch.ones_like(z)], dim=-1), all_valid

    if cam.kind == "fisheye":
        uv = (image_point - pp) / fl
        delta = torch.linalg.norm(uv, dim=-1)
        fwd = cam.fisheye_fwd_poly[..., None, :]
        dfwd = cam.fisheye_dfwd_poly[..., None, :]
        theta, converged = poly_inverse_newton(
            lambda x: eval_poly_odd(fwd, x), lambda x: eval_poly_even(dfwd, x),
            eval_poly_full(cam.fisheye_approx_bwd[..., None, :], delta), delta,
            n_iterations=cam.opts.newton_iterations)
        valid = (theta >= 0.0) & (theta < cam.max_angle[..., None]) & converged
        is_center = delta < cam.opts.min_2d_norm
        return _straight_or(is_center, theta, uv, torch.where(is_center, 1.0, delta)), valid

    if cam.kind == "ftheta":
        cde = cam.ftheta_linear_cde[..., None, :]
        c, d, e = cde[..., 0], cde[..., 1], cde[..., 2]
        px = image_point[..., 0] - pp[..., 0]
        py = image_point[..., 1] - pp[..., 1]
        det_inv = 1.0 / (c - e * d)
        uv = torch.stack([(px - d * py) * det_inv, (-e * px + c * py) * det_inv], dim=-1)
        delta = torch.linalg.norm(uv, dim=-1)
        a2p = cam.ftheta_a2p[..., None, :]
        p2a = cam.ftheta_p2a[..., None, :]
        dref = cam.ftheta_dref[..., None, :]
        if cam.ftheta_reference_poly == FThetaPolynomialType.PIXELDIST_TO_ANGLE:
            theta = eval_poly_full(p2a, delta)
            converged = torch.ones_like(theta, dtype=torch.bool)
        else:
            theta, converged = poly_inverse_newton(
                lambda x: eval_poly_full(a2p, x), lambda x: eval_poly_full(dref, x),
                eval_poly_full(p2a, delta), delta, n_iterations=cam.opts.newton_iterations)
        is_center = delta < cam.opts.min_2d_norm
        ray = _straight_or(is_center | ~converged, theta, uv, torch.where(is_center, 1.0, delta))
        return _safe_normalize(ray), converged

    raise ValueError(f"unsupported camera kind: {cam.kind!r}")


# ---------------------------------------------------------------------------
# Shutter-pose composition
# ---------------------------------------------------------------------------


def image_point_to_world_ray_shutter_pose(
    cam: CameraModel,
    image_point: Tensor,  # [..., C, M, 2]
    shutter_pose_start: Tensor,  # [..., C, 7]
    shutter_pose_end: Tensor,  # [..., C, 7]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pixels -> world rays through the pose interpolated at each pixel's
    shutter time; invalid rays are zero.  Returns (origins, directions,
    valid)."""
    camera_ray, valid = image_point_to_camera_ray(cam, image_point)
    t = shutter_relative_frame_time(cam, image_point)
    pose = interpolate_shutter_pose(shutter_pose_start[..., None, :],
                                    shutter_pose_end[..., None, :], t)
    org, dirn = pose_camera_ray_to_world_ray(pose, camera_ray)
    v = valid[..., None].to(org.dtype)
    return org * v, dirn * v, valid


def generate_rays(
    cam: CameraModel,
    width: int,
    height: int,
    viewmats: Tensor,  # [..., C, 4, 4]
    viewmats_rs: Optional[Tensor] = None,  # [..., C, 4, 4]
) -> Tensor:
    """World-space rays through every pixel centre (x + 0.5, y + 0.5):
    [..., C, H, W, 6] as (origin, direction)."""
    dev = viewmats.device
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")  # [H, W]
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # [P, 2]

    pose_start = viewmat_to_pose(viewmats)  # [..., C, 7]
    pose_end = viewmat_to_pose(viewmats_rs) if viewmats_rs is not None else pose_start
    B = tuple(pose_start.shape[:-1])
    pix = pix.expand(B + tuple(pix.shape))
    org, dirn, _ = image_point_to_world_ray_shutter_pose(cam, pix, pose_start, pose_end)
    return torch.cat([org.expand_as(dirn), dirn], dim=-1).reshape(B + (height, width, 6))


def world_point_to_image_point_shutter_pose(
    cam: CameraModel,
    world_points: Tensor,  # [..., C, M, 3]
    shutter_pose_start: Tensor,  # [..., C, 7]
    shutter_pose_end: Tensor,  # [..., C, 7]
    margin_factor: float,
    rolling_shutter_iterations: int = 10,
) -> Tuple[Tensor, Tensor]:
    """Project world points, refining the rolling-shutter pose in a fixed
    number of iterations.  A global shutter, or `shutter_pose_end` being the
    very tensor `shutter_pose_start` (the caller's mark of a frame with one
    pose: a lidar always counts as rolling), returns the first projection."""
    ps = shutter_pose_start[..., None, :]
    pt_start, valid_start = camera_ray_to_image_point(
        cam, pose_world_points_to_camera_ray(ps, world_points), margin_factor)
    shutter = (RollingShutterType.ROLLING_LEFT_TO_RIGHT if cam.kind == "lidar"
               else cam.shutter_type)
    if shutter == RollingShutterType.GLOBAL or shutter_pose_end is shutter_pose_start:
        return pt_start, valid_start

    pe = shutter_pose_end[..., None, :]
    pt_end, valid_end = camera_ray_to_image_point(
        cam, pose_world_points_to_camera_ray(pe, world_points), margin_factor)
    init_pt = torch.where(valid_start[..., None], pt_start, pt_end)
    valid = valid_start | valid_end

    pt_prev, valid_rs = init_pt, valid
    for _ in range(rolling_shutter_iterations):
        t = shutter_relative_frame_time(cam, pt_prev)
        pose_rs = interpolate_shutter_pose(ps, pe, t)
        pt_prev, valid_rs = camera_ray_to_image_point(
            cam, pose_world_points_to_camera_ray(pose_rs, world_points), margin_factor)
    return torch.where(valid[..., None], pt_prev, init_pt), valid & valid_rs
