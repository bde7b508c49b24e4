"""Port parity: the unscented-transform projection against gsplat_tpu's, and
the gradients of rasterization(with_ut=True) on the classic composite
against jax.grad of the JAX package's (Pallas in interpret mode).

Projection outputs: radii exactly, everything else within 1e-5 of each
output's largest entry (pixel coordinates in the hundreds carry float32
ulps of 6e-5).  The UT's centre weight is -99 (alpha 0.1), so the mean
shows a one-ulp difference of a sigma point about 200x, and a conic
inverts a covariance that is itself a difference: where the two libraries'
transcendental functions (the lidar's atan2 and asin, the rolling
shutter's slerp) or sums (the all-sigma-points mode's multiply-then-sum)
round apart, the band is 1e-4 of the largest entry.  Gradients: within
4e-4 of each input's largest entry, the eval3d suite's band
(tests/test_rasterize_eval3d.py:125-128).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.projection_ut import fully_fused_projection_ut as j_ut
from gsplat_tpu.rendering import rasterization as j_rast
from gsplat_tpu.sensors import FThetaCameraDistortionParameters as JFT
from gsplat_tpu.sensors import FThetaPolynomialType as JFP
from gsplat_tpu.sensors import RollingShutterType as JRS
from gsplat_tpu.sensors import lidars as jl
from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch.ops.projection_ut import fully_fused_projection_ut
from gsplat_tpu_torch.sensors import FThetaCameraDistortionParameters as TFT
from gsplat_tpu_torch.sensors import FThetaPolynomialType as TFP
from gsplat_tpu_torch.sensors import RollingShutterType as TRS
from gsplat_tpu_torch.sensors import lidars as tl

W, H = 320, 240


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(N=160, seed=5, C=2):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2.0, 6.0, N)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.08, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, N).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        a = rng.uniform(-0.05, 0.05)
        vm[c, :3, :3] = [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
        vm[c, :3, 3] = rng.uniform(-0.1, 0.1, 3)
    Ks = np.zeros((C, 3, 3), np.float32)
    Ks[:, 0, 0], Ks[:, 1, 1] = 160.0, 165.0
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = W / 2, H / 2, 1.0
    return dict(means=means, quats=quats, scales=scales, opac=opac, vm=vm, Ks=Ks)


def _ftheta(mod, kind):
    return mod(reference_poly=kind.ANGLE_TO_PIXELDIST,
               angle_to_pixeldist_poly=(0.0, 160.0, 0.0, -5.0, 0.0, 0.0),
               pixeldist_to_angle_poly=(0.0, 1.0 / 160.0, 0.0, 5.0 / 160.0**4, 0.0, 0.0),
               max_angle=1.2)


def _lidar(mod, **kw):
    el = np.linspace(0.35, -0.35, 24).astype(np.float32)
    az = np.linspace(math.radians(60), math.radians(-60), 80).astype(np.float32)
    return mod.make_lidar(el, az, np.zeros(24, np.float32), **kw)


CASES = {
    "pinhole": {},
    "opencv": dict(radial_coeffs=[[0.05, -0.01, 0.002]] * 2, tangential_coeffs=[[1e-3, -5e-4]] * 2),
    "fisheye": dict(camera_model="fisheye", radial_coeffs=[[0.02, -0.005, 0.001, 0.0]] * 2),
    "ftheta": dict(camera_model="ftheta", ftheta=True),
    "lidar": dict(camera_model="lidar", global_z_order=False),
    "rolling_shutter": dict(radial_coeffs=[[0.03, 0.0]] * 2, rolling=True),
    "all_sigma_points": dict(camera_model="fisheye", radial_coeffs=[[0.02, 0.0, 0.0, 0.0]] * 2,
                             strict=True),
}


def _kwargs(name, s, jax_side):
    spec = dict(CASES[name])
    conv = jnp.asarray if jax_side else _t
    kw = {}
    for k in ("radial_coeffs", "tangential_coeffs"):
        if k in spec:
            kw[k] = conv(np.asarray(spec.pop(k), np.float32))
    if spec.pop("ftheta", False):
        kw["ftheta_coeffs"] = _ftheta(JFT, JFP) if jax_side else _ftheta(TFT, TFP)
    if spec.pop("rolling", False):
        vm_rs = s["vm"].copy()
        vm_rs[:, 0, 3] += 0.08
        kw["rolling_shutter"] = (JRS if jax_side else TRS).ROLLING_TOP_TO_BOTTOM
        kw["viewmats_rs"] = conv(vm_rs)
    if spec.pop("strict", False):
        from gsplat_tpu.sensors import UnscentedTransformParameters as JUT
        from gsplat_tpu_torch.sensors import UnscentedTransformParameters as TUT
        kw["ut_params"] = (JUT if jax_side else TUT)(require_all_sigma_points_valid=True)
    if spec.get("camera_model") == "lidar":
        kw["lidar_coeffs"] = _lidar(jl) if jax_side else _lidar(tl, device="cpu")
    kw.update(spec)
    return kw


@pytest.mark.parametrize("name", list(CASES))
def test_projection_ut_matches(name):
    s = _scene()
    if name == "lidar":  # in front of the lidar, which looks along +x
        s["means"] = s["means"][:, [2, 0, 1]].copy()
    args = [s[k] for k in ("means", "quats", "scales", "opac", "vm", "Ks")]
    want = j_ut(*map(jnp.asarray, args), W, H, calc_compensations=True,
                **_kwargs(name, s, True))
    got = fully_fused_projection_ut(*map(_t, args), W, H, calc_compensations=True,
                                    **_kwargs(name, s, False))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int((got[0] > 0).all(-1).sum()) > 40
    tol = 1e-4 if name in ("lidar", "rolling_shutter", "all_sigma_points") else 1e-5
    for what, g, w in zip(("means2d", "depths", "conics", "compensations"), got[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=what)


@pytest.mark.parametrize("model", ["opencv", "fisheye"])
def test_rasterization_with_ut_gradients(model):
    """rasterization(with_ut=True) on the classic composite: the image and
    the gradients of means, quats, scales, opacities and colours."""
    s = _scene(N=120, seed=11, C=1)
    w, h = 64, 48
    s["Ks"][:, 0, 0] = s["Ks"][:, 1, 1] = 40.0
    s["Ks"][:, 0, 2], s["Ks"][:, 1, 2] = w / 2, h / 2
    s["scales"] *= 2.0
    rng = np.random.default_rng(12)
    colors = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    kw = dict(with_ut=True)
    if model == "fisheye":
        kw["camera_model"] = "fisheye"
    rad = np.array([[0.03, -0.01, 0.0, 0.0]], np.float32)
    names = ("means", "quats", "scales", "opac")

    def jloss(m, q, sc, o, c):
        img, a, _ = j_rast(m, q, sc, o, c, jnp.asarray(s["vm"]), jnp.asarray(s["Ks"]), w, h,
                           radial_coeffs=jnp.asarray(rad), **kw)
        return jnp.sum((img - tgt) ** 2) + 0.3 * jnp.sum(a), img

    jin = [jnp.asarray(s[k]) for k in names] + [jnp.asarray(colors)]
    (_, jimg), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(*jin)
    xs = [_t(s[k]).requires_grad_() for k in names] + [_t(colors).requires_grad_()]
    img, a, meta = rasterization(*xs, _t(s["vm"]), _t(s["Ks"]), w, h, radial_coeffs=_t(rad), **kw)
    (((img - _t(tgt)) ** 2).sum() + 0.3 * a.sum()).backward()
    assert not bool(meta["isect_overflow"])
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), rtol=0, atol=2e-4)
    for name, x, g in zip(names + ("colors",), xs, jg):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=4e-4 * max(np.abs(g).max(), 1.0),
                                   err_msg=name)
