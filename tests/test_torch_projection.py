"""Port parity: fully_fused_projection and the math helpers vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import math as jm
from gsplat_tpu.ops import projection as jp
from gsplat_tpu_torch.ops import math as tm
from gsplat_tpu_torch.ops import projection as tp


def _cameras(C=3, W=64, H=48, seed=0):
    rng = np.random.default_rng(seed)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        a = rng.uniform(-0.3, 0.3, 3)
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        viewmats[c, :3, :3] = Rz @ Rx
        viewmats[c, :3, 3] = rng.uniform(-0.5, 0.5, 3) + np.array([0, 0, 4.0])
    Ks = np.tile(np.array([[50.0, 0, W / 2], [0, 52.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    return viewmats.astype(np.float32), Ks, W, H


def _gaussians(N=400, seed=1):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.3, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, (N,)).astype(np.float32)
    return means, quats, scales, opac


def _both(fn_j, fn_t, *args, **kw):
    rj = fn_j(*(None if a is None else jnp.asarray(a) for a in args), **kw)
    rt = fn_t(*(None if a is None else torch.from_numpy(a) for a in args), **kw)
    return rj, rt


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
@pytest.mark.parametrize("antialiased", [False, True])
def test_fully_fused_projection_matches_jax(camera_model, antialiased):
    viewmats, Ks, W, H = _cameras()
    means, quats, scales, opac = _gaussians()
    if camera_model == "ortho":
        Ks = Ks.copy()
        Ks[:, 0, 0] = Ks[:, 1, 1] = 10.0
    kw = dict(width=W, height=H, radius_clip=0.5, calc_compensations=antialiased,
              camera_model=camera_model, near_plane=0.1, far_plane=50.0)
    (rj, mj, dj, cj, compj), (rt, mt, dt, ct, compt) = _both(
        lambda m, q, s, v, k, o, **k2: jp.fully_fused_projection(m, None, q, s, v, k, opacities=o, **k2),
        lambda m, q, s, v, k, o, **k2: tp.fully_fused_projection(m, None, q, s, v, k, opacities=o, **k2),
        means, quats, scales, viewmats, Ks, opac, **kw,
    )
    # Radii are integers from ceil(): they must agree exactly.
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    live = (np.asarray(rj) > 0).all(-1)
    assert 0 < live.sum() < live.size  # both culled and live gaussians
    # Continuous outputs: the same f32 formulas, ~1e-5 relative (transcendental
    # and division ulps differ between XLA and PyTorch).  means2d is x + cx
    # with cx = 32 px, so near 0 its error is absolute, at the ulp of 32-64
    # (3.8e-6): atol 1e-5 px.
    np.testing.assert_allclose(mt.numpy()[live], np.asarray(mj)[live], rtol=1e-5, atol=1e-5)
    for a, b in ((dt, dj), (ct, cj)):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live], rtol=1e-5, atol=1e-6)
    if antialiased:
        np.testing.assert_allclose(compt.numpy(), np.asarray(compj), rtol=1e-5, atol=1e-6)
    else:
        assert compt is None and compj is None


def test_projection_from_covars_and_batch():
    """Covariance input ([N, 6] upper triangle) and a leading batch dim."""
    viewmats, Ks, W, H = _cameras(C=2)
    means, quats, scales, opac = _gaussians(N=100, seed=2)
    cov, _ = jm.quat_scale_to_covar_preci(jnp.asarray(quats), jnp.asarray(scales),
                                          compute_preci=False, triu=True)
    cov = np.asarray(cov)
    vb = np.stack([viewmats, viewmats[::-1]])  # [B=2, C=2, 4, 4]
    Kb = np.stack([Ks, Ks])
    mb = np.stack([means, means + 0.1])
    cb = np.stack([cov, cov])
    rj = jp.fully_fused_projection(jnp.asarray(mb), jnp.asarray(cb), None, None,
                                   jnp.asarray(vb), jnp.asarray(Kb), W, H)
    rt = tp.fully_fused_projection(torch.from_numpy(mb), torch.from_numpy(cb), None, None,
                                   torch.from_numpy(vb), torch.from_numpy(Kb), W, H)
    np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
    for a, b in zip(rt[1:4], rj[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_math_helpers_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((50, 4)).astype(np.float32)
    q[0] = 0.0  # zero quaternion normalizes to zero
    s = rng.uniform(0.05, 2.0, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.normalize(torch.from_numpy(q)).numpy(),
                               np.asarray(jm.normalize(jnp.asarray(q))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jm.quat_to_rotmat(jnp.asarray(q))), rtol=1e-6, atol=1e-6)
    for triu in (False, True):
        cj, pj = jm.quat_scale_to_covar_preci(jnp.asarray(q[1:]), jnp.asarray(s[1:]), triu=triu)
        ct, pt = tm.quat_scale_to_covar_preci(torch.from_numpy(q[1:]), torch.from_numpy(s[1:]),
                                              triu=triu)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-4)
