"""Port parity: the sensor models of gsplat_tpu_torch.sensors against
gsplat_tpu.sensors on the same numpy inputs.

Every camera model both ways, generate_rays with and without a rolling
shutter, the rolling-shutter projection, the windshield model, and the
lidar: make_lidar, its ray and image-point functions, generate_lidar_rays,
the port's interp against jnp.interp, and angle_extent_to_element_grid.
Rays and unit vectors agree within 1e-5; image points within 1e-5 of the
largest coordinate (pixel coordinates in the hundreds carry float32 ulps of
6e-5, and the transcendental functions of the two libraries differ by an
ulp); element-grid radii exactly.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import sensors as js
from gsplat_tpu.sensors import external as jext
from gsplat_tpu.sensors import lidars as jl
from gsplat_tpu_torch import sensors as ts
from gsplat_tpu_torch.sensors import cameras as tcam
from gsplat_tpu_torch.sensors import external as text
from gsplat_tpu_torch.sensors import lidars as tl

W, H = 640, 480


def _t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=1e-5, rel=False, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _intrinsics(C=2):
    return (np.array([[320.0, 330.0]] * C, np.float32), np.array([[W / 2, H / 2]] * C, np.float32))


def _rays(C=2, M=64, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(C, M, 3)).astype(np.float32)
    d[..., 2] = np.abs(d[..., 2]) + 1.0
    d[..., :2] *= 0.3
    d[0, 0] = [0.0, 0.0, 1.0]  # on the axis
    d[0, 1] = [0.2, 0.1, -1.0]  # behind the camera
    return d


def _ftheta(reference):
    return dict(
        reference_poly=reference,
        angle_to_pixeldist_poly=(0.0, 300.0, 0.0, -10.0, 0.0, 0.0),
        pixeldist_to_angle_poly=(0.0, 1.0 / 300.0, 0.0, 10.0 / 300.0**4, 0.0, 0.0),
        max_angle=1.2, linear_cde=(1.0, 0.002, -0.001),
    )


WINDSHIELD = dict(
    horizontal_poly=(0.0, 1.01, 0.002, 0.01, 0.0, -0.003),
    vertical_poly=(0.001, 0.003, 0.99, 0.0, 0.004, 0.002),
    horizontal_poly_inverse=(0.0, 0.99, -0.002, -0.01, 0.0, 0.003),
    vertical_poly_inverse=(-0.001, -0.003, 1.01, 0.0, -0.004, -0.002),
)

CAMERAS = {
    "pinhole": dict(kind="pinhole"),
    "opencv_pinhole": dict(kind="pinhole", radial_coeffs=[[0.05, -0.01, 0.002, 0.0]] * 2,
                           tangential_coeffs=[[1e-3, -5e-4]] * 2,
                           thin_prism_coeffs=[[1e-4, 0.0, -1e-4, 0.0]] * 2),
    "opencv_rational": dict(kind="pinhole", radial_coeffs=[[0.1, -0.02, 0.003, 0.05, -0.01, 0.001]] * 2),
    "ortho": dict(kind="ortho"),
    "fisheye": dict(kind="fisheye", radial_coeffs=[[0.02, -0.005, 0.001, 0.0]] * 2),
    "fisheye_k4": dict(kind="fisheye", radial_coeffs=[[0.02, -0.005, 0.001, -0.0004]] * 2),
    "ftheta_a2p": dict(kind="ftheta", ftheta="A"),
    "ftheta_p2a": dict(kind="ftheta", ftheta="P"),
    "pinhole_windshield": dict(kind="pinhole", external=True),
}


def _both_cameras(name, shutter=None):
    """(the JAX camera, the port's) built from the same numbers."""
    spec = dict(CAMERAS[name])
    kind = spec.pop("kind")
    fl, pp = _intrinsics()
    out = []
    for mod, conv, ext, ftp in ((js, jnp.asarray, jext, js.FThetaPolynomialType),
                                (ts, _t, text, ts.FThetaPolynomialType)):
        kw = {k: conv(np.asarray(v, np.float32)) for k, v in spec.items()
              if k not in ("ftheta", "external")}
        if "ftheta" in spec:
            ref = (ftp.ANGLE_TO_PIXELDIST if spec["ftheta"] == "A" else ftp.PIXELDIST_TO_ANGLE)
            kw["ftheta_coeffs"] = mod.FThetaCameraDistortionParameters(**_ftheta(ref))
        if spec.get("external"):
            kw["external_distortion"] = ext.BivariateWindshieldModelParameters(**WINDSHIELD)
        if shutter is not None:
            kw["shutter_type"] = getattr(mod.RollingShutterType, shutter)
        out.append(mod.make_camera(kind, W, H, None if kind == "ftheta" else conv(fl), conv(pp),
                                   **kw))
    return out


@pytest.mark.parametrize("name", list(CAMERAS))
def test_camera_models_both_ways(name):
    jcam, tcm = _both_cameras(name)
    assert jcam.kind == tcm.kind
    if jcam.max_angle is not None:
        close(tcm.max_angle, jcam.max_angle, what="max_angle")
    rays = _rays()
    jpt, jv = js.camera_ray_to_image_point(jcam, jnp.asarray(rays), 0.1)
    tpt, tv = ts.camera_ray_to_image_point(tcm, _t(rays), 0.1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(tpt, jpt, rel=True, what="image points")
    assert tv.sum() > 40
    pix = np.asarray(jpt)
    jray, jc = js.image_point_to_camera_ray(jcam, jnp.asarray(pix))
    tray, tc = ts.image_point_to_camera_ray(tcm, _t(pix))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    close(tray, jray, what="camera rays")


def _poses(C=2, seed=1, move=0.0):
    rng = np.random.default_rng(seed)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    ang = rng.uniform(-0.05, 0.05, C)
    for c in range(C):
        ca, sa = np.cos(ang[c]), np.sin(ang[c])
        vm[c, :3, :3] = [[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]]
        vm[c, :3, 3] = rng.uniform(-0.1, 0.1, 3)
    vm_rs = vm.copy()
    vm_rs[:, 0, 3] += move
    a = 0.03
    vm_rs[:, :3, :3] = vm[:, :3, :3] @ np.array(
        [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]], np.float32)
    return vm, vm_rs


@pytest.mark.parametrize("name", ["pinhole", "opencv_pinhole", "fisheye", "ftheta_a2p"])
@pytest.mark.parametrize("rolling", [False, True])
def test_generate_rays(name, rolling):
    shutter = "ROLLING_TOP_TO_BOTTOM" if rolling else None
    jcam, tcm = _both_cameras(name, shutter)
    vm, vm_rs = _poses(move=0.2)
    w, h = 48, 36
    jr = js.generate_rays(jcam, w, h, jnp.asarray(vm), jnp.asarray(vm_rs) if rolling else None)
    tr = ts.generate_rays(tcm, w, h, _t(vm), _t(vm_rs) if rolling else None)
    close(tr, jr, what="rays")


@pytest.mark.parametrize("shutter", ["ROLLING_TOP_TO_BOTTOM", "ROLLING_LEFT_TO_RIGHT",
                                     "ROLLING_BOTTOM_TO_TOP", "ROLLING_RIGHT_TO_LEFT"])
def test_rolling_shutter_projection(shutter):
    jcam, tcm = _both_cameras("opencv_pinhole", shutter)
    vm, vm_rs = _poses(seed=2, move=0.2)
    pts = _rays(seed=3)[:, 2:] + np.array([0.0, 0.0, 3.0], np.float32)
    jp0, jp1 = js.viewmat_to_pose(jnp.asarray(vm)), js.viewmat_to_pose(jnp.asarray(vm_rs))
    tp0, tp1 = ts.viewmat_to_pose(_t(vm)), ts.viewmat_to_pose(_t(vm_rs))
    close(tp0, jp0, what="pose")
    jpt, jv = js.world_point_to_image_point_shutter_pose(jcam, jnp.asarray(pts), jp0, jp1, 0.1)
    tpt, tv = ts.world_point_to_image_point_shutter_pose(tcm, _t(pts), tp0, tp1, 0.1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    close(tpt, jpt, rel=True, what="rolling-shutter image points")
    # the interpolated pose and the world rays it gives
    t = np.linspace(0, 1, 5, dtype=np.float32)
    close(ts.interpolate_shutter_pose(tp0[:, None], tp1[:, None], _t(np.tile(t, (2, 1)))),
          js.interpolate_shutter_pose(jp0[:, None], jp1[:, None], jnp.tile(t, (2, 1))))
    pix = np.asarray(jpt)
    jo, jd, _ = js.image_point_to_world_ray_shutter_pose(jcam, jnp.asarray(pix), jp0, jp1)
    to, td, _ = ts.image_point_to_world_ray_shutter_pose(tcm, _t(pix), tp0, tp1)
    close(to, jo, what="origins")
    close(td, jd, what="directions")


def test_one_pose_tensor_skips_the_rolling_shutter_iterations(monkeypatch):
    """The very same pose tensor as start and end marks a frame with one
    pose: even a rolling-shutter camera (or a lidar) then projects once.  A
    copy with equal values runs the ten refinement iterations."""
    _, tcm = _both_cameras("pinhole", "ROLLING_TOP_TO_BOTTOM")
    pose = ts.viewmat_to_pose(_t(_poses()[0]))
    pts = _t(_rays()[:, 2:] + np.array([0.0, 0.0, 3.0], np.float32))
    calls = []
    real = tcam.shutter_relative_frame_time
    monkeypatch.setattr(tcam, "shutter_relative_frame_time",
                        lambda *a: calls.append(1) or real(*a))
    once = ts.world_point_to_image_point_shutter_pose(tcm, pts, pose, pose, 0.1)
    assert calls == []
    again = ts.world_point_to_image_point_shutter_pose(tcm, pts, pose, pose.clone(), 0.1)
    assert len(calls) == 10
    assert torch.equal(once[1], again[1])
    close(again[0], once[0].numpy(), tol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_windshield_model(inverse):
    rays = _rays()
    rays[0, 2] = 0.0  # shorter than 1e-6: passes unchanged
    jp = jext.BivariateWindshieldModelParameters(**WINDSHIELD)
    tp = text.BivariateWindshieldModelParameters(**WINDSHIELD)
    for src in ((0.5,), (0.1, 1.0, 0.2), tuple(np.arange(21) * 0.01)):
        np.testing.assert_array_equal(text.pad_coefficients_to_max_order(src),
                                      jext.pad_coefficients_to_max_order(src))
    got = text.apply_external_distortion(tp, _t(rays), inverse=inverse)
    want = jext.apply_external_distortion(jp, jnp.asarray(rays), inverse=inverse)
    close(got, want)
    ident = text.BivariateWindshieldModelParameters.identity()
    unit = rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-30)
    close(text.apply_external_distortion(ident, _t(unit))[0, 3:], unit[0, 3:], tol=2e-6)


def _lidar_args(n_rows=32, n_cols=96, full_circle=False, offsets=True):
    el = np.linspace(0.35, -0.35, n_rows).astype(np.float32)
    if full_circle:
        az = (math.pi - np.arange(n_cols) * (2 * math.pi / n_cols)).astype(np.float32)
    else:
        az = np.linspace(math.radians(60), math.radians(-60), n_cols).astype(np.float32)
    off = (0.001 * np.sin(np.arange(n_rows)) * offsets).astype(np.float32)
    return el, az, off


@pytest.mark.parametrize("layout", ["front", "full_circle", "counter_clockwise"])
def test_make_lidar_and_its_rays(layout):
    el, az, off = _lidar_args(full_circle=layout == "full_circle", offsets=layout != "full_circle")
    if layout == "counter_clockwise":
        az = az[::-1].copy()
    sd = "COUNTER_CLOCKWISE" if layout == "counter_clockwise" else "CLOCKWISE"
    jlid = jl.make_lidar(el, az, off, getattr(jl.SpinningDirection, sd))
    tlid = tl.make_lidar(el, az, off, getattr(tl.SpinningDirection, sd), device="cpu")
    for f in ("fov_vert_start", "fov_vert_span", "fov_horiz_start", "fov_horiz_span",
              "fov_eps_rad", "n_rows", "n_columns"):
        assert getattr(tlid, f) == getattr(jlid, f), f
    jpts = jl.lidar_element_image_points(jlid)
    close(tl.lidar_element_image_points(tlid), jpts, rel=True)
    jr, jv = jl.lidar_image_point_to_ray(jlid, jpts)
    tr, tv = tl.lidar_image_point_to_ray(tlid, _t(jpts))
    close(tr, jr)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rng = np.random.default_rng(7)
    probe = rng.normal(size=(1, 300, 3)).astype(np.float32)
    jp, jpv = jl.lidar_ray_to_image_point(jlid, jnp.asarray(probe), 0.1)
    tp, tpv = tl.lidar_ray_to_image_point(tlid, _t(probe), 0.1)
    close(tp, jp, rel=True)
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    close(tl.lidar_shutter_relative_frame_time(tlid, _t(jp)),
          jl.lidar_shutter_relative_frame_time(jlid, jp))
    vm0 = np.eye(4, dtype=np.float32)[None]
    vm0[0, :3, 3] = [0.1, -0.2, 0.05]
    vm1 = vm0.copy()
    vm1[0, 1, 3] += 0.3
    for rs in (None, vm1):
        close(tl.generate_lidar_rays(tlid, _t(vm0), None if rs is None else _t(rs)),
              jl.generate_lidar_rays(jlid, jnp.asarray(vm0), None if rs is None else jnp.asarray(rs)),
              what="lidar rays")


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(-1, 2, 40)).astype(np.float32)
    xp[10] = xp[9]  # a repeated abscissa
    fp = rng.normal(size=40).astype(np.float32)
    x = np.concatenate([rng.uniform(-2, 3, 500), xp, [xp[0], xp[-1]]]).astype(np.float32)
    close(tl.interp(_t(x), _t(xp), _t(fp)), jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))


@pytest.mark.parametrize("full_circle", [False, True])
def test_angle_extent_to_element_grid(full_circle):
    el, az, off = _lidar_args(full_circle=full_circle, offsets=not full_circle)
    jlid = jl.make_lidar(el, az, off)
    tlid = tl.make_lidar(el, az, off, device="cpu")
    rng = np.random.default_rng(5)
    N = 400
    az_s = rng.uniform(-math.pi, math.pi, N) if full_circle else rng.uniform(-1.2, 1.2, N)
    m2 = np.stack([az_s, rng.uniform(-0.4, 0.4, N)], -1).astype(np.float32) * 1024.0
    radii = rng.integers(0, 60, (1, N, 2)).astype(np.int32)
    radii[0, ::9, 0] = 0  # culled
    jm, jr = jl.angle_extent_to_element_grid(jlid, jnp.asarray(m2[None]), jnp.asarray(radii))
    tm, tr = tl.angle_extent_to_element_grid(tlid, _t(m2[None]), _t(radii))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    close(tm, jm, rel=True)
    assert tr.dtype == torch.int32 and int(tr.max()) > 0
