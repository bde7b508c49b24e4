"""Port parity: the three plain rasterizers (the oracles) against the JAX
package's: rasterize_to_pixels_ref (with backgrounds and masks),
rasterize_to_pixels_2dgs_ref and rasterize_to_pixels_eval3d_ref (with hit
distance and normals), on the same seeded inputs; and the banded walk of
the image (many bands) against one band.

Tolerances: images and alphas within 2e-6 (3DGS), 5e-6 (2DGS colours,
normals, distortion; the median exactly), 2e-5 (eval3d; its 3x3 products
are summed in another order than XLA's dot).  The port's transmittance is
the serial float32 product of the kernels, XLA's CPU cumprod a blocked
scan, and torch's exp and XLA's differ by an ulp on about a tenth of
inputs: on these scenes no gate or stop decision flips (a flip would show
as a whole gaussian's weight, far over the bands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.projection import fully_fused_projection as j_project
from gsplat_tpu.ops.projection2d import fully_fused_projection_2dgs as j_project_2dgs
from gsplat_tpu.ops.rasterize2d_ref import rasterize_to_pixels_2dgs_ref as j_ref2d
from gsplat_tpu.ops.rasterize_eval3d_ref import rasterize_to_pixels_eval3d_ref as j_ref3d
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref as j_ref
from gsplat_tpu.sensors import generate_rays, make_camera
from gsplat_tpu_torch.ops import rasterize_ref as tref
from gsplat_tpu_torch.ops.rasterize2d_ref import rasterize_to_pixels_2dgs_ref as t_ref2d
from gsplat_tpu_torch.ops.rasterize_eval3d_ref import rasterize_to_pixels_eval3d_ref as t_ref3d
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref as t_ref

W, H, TS = 40, 35, 16
TW, TH = -(-W // TS), -(-H // TS)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _isect(m2, radii, depths, I, cap=4096):
    isect = isect_tiles(m2, radii, depths, TS, TW, TH, capacity=cap)
    return isect, isect_offset_encode(isect.tile_keys, I, TW, TH)


@pytest.fixture(scope="module")
def scene3d():
    """The contributing suite's 2-image scene (tests/test_contributing.py:20-50)."""
    rng = np.random.default_rng(5)
    I, N, D = 2, 150, 3
    means2d = rng.uniform(-5, 45, (I, N, 2)).astype(np.float32)
    L = rng.standard_normal((I, N, 2, 2)).astype(np.float32) * 0.4
    cov = L @ L.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    colors = rng.random((I, N, D)).astype(np.float32)
    opacities = np.clip(rng.random((I, N)) * 1.2, 0, 1).astype(np.float32)
    radii = np.full((I, N, 2), 5, np.int32)
    radii[:, ::7] = 0
    depths = (rng.random((I, N)) * 5 + 0.1).astype(np.float32)
    isect, offsets = _isect(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), I, 2048)
    bg = rng.random((I, D)).astype(np.float32)
    masks = rng.random((I, TH, TW)) > 0.3
    return dict(means2d=means2d, conics=conics, colors=colors, opacities=opacities,
                offsets=np.asarray(offsets), flatten_ids=np.asarray(isect.flatten_ids),
                n_isects=np.asarray(isect.n_isects), bg=bg, masks=masks)


def _args3d(s, conv):
    return (conv(s["means2d"]), conv(s["conics"]), conv(s["colors"]), conv(s["opacities"]), W, H,
            TS, conv(s["offsets"]), conv(s["flatten_ids"]), conv(s["n_isects"]), 512)


@pytest.mark.parametrize("bg,mask", [(False, False), (True, False), (True, True), (False, True)])
def test_rasterize_ref_matches_jax(scene3d, bg, mask):
    s = scene3d
    kw_j = dict(backgrounds=jnp.asarray(s["bg"]) if bg else None,
                masks=jnp.asarray(s["masks"]) if mask else None)
    kw_t = dict(backgrounds=_t(s["bg"]) if bg else None, masks=_t(s["masks"]) if mask else None)
    jc, ja = j_ref(*_args3d(s, jnp.asarray), **kw_j)
    tc, ta = t_ref(*_args3d(s, _t), **kw_t)
    assert tc.shape == (2, H, W, 3) and ta.shape == (2, H, W, 1)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=2e-6)
    assert float(ta.mean()) > 0.02


def test_banded_route_equals_one_band(scene3d, monkeypatch):
    """A budget of 3 tiles' worth of pairs walks the image in many bands,
    each with its own slot count; the result is the single band's, bit for
    bit (the per-pixel arithmetic does not depend on the band)."""
    s = scene3d
    one = t_ref(*_args3d(s, _t), backgrounds=_t(s["bg"]))
    counts = tref._span_counts(tref._span_bounds(_t(s["offsets"]), _t(s["n_isects"])), 0, 512)
    monkeypatch.setattr(tref, "_BAND_BUDGET", 3 * TS * TS * int(counts.max()))
    plan = tref._band_plan(counts, TS * TS)
    assert len(plan) > 3 and len({L for _, _, L in plan}) > 1
    many = t_ref(*_args3d(s, _t), backgrounds=_t(s["bg"]))
    for a, b in zip(one, many):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def scene2d():
    rng = np.random.default_rng(5)
    N, C = 250, 2
    means = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2, 8, N)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.5 + 0.1).astype(np.float32)
    opacities = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[1, :3, 3] = [0.2, -0.1, 0.4]
    Ks = np.array([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]] * C, np.float32)
    radii, m2, d, M, nrm = j_project_2dgs(*map(jnp.asarray, (means, quats, scales, viewmats, Ks)),
                                          W, H)
    isect, offsets = _isect(m2, radii, d, C, 16384)
    feats = jnp.concatenate([jnp.broadcast_to(jnp.asarray(colors)[None], (C, N, 3)),
                             d[..., None]], axis=-1)
    return dict(m2=m2, M=M, feats=feats, nrm=nrm,
                op=jnp.broadcast_to(jnp.asarray(opacities)[None], (C, N)), offsets=offsets,
                flatten_ids=isect.flatten_ids, n_isects=isect.n_isects,
                bg=jnp.asarray(rng.random((C, 4)).astype(np.float32)))


def test_rasterize2d_ref_matches_jax(scene2d):
    s = scene2d
    keys = ("m2", "M", "feats", "nrm", "op")
    tail = ("offsets", "flatten_ids", "n_isects")
    want = j_ref2d(*(s[k] for k in keys), W, H, TS, *(s[k] for k in tail), 512,
                   backgrounds=s["bg"])
    got = t_ref2d(*(_t(s[k]) for k in keys), W, H, TS, *(_t(s[k]) for k in tail), 512,
                  backgrounds=_t(s["bg"]))
    for name, a, b in zip(("colors", "alphas", "normals", "distort", "median"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        if name == "median":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-6, err_msg=name)
    assert float(got[1].mean()) > 0.05 and float((got[4] > 0).float().mean()) > 0.05


@pytest.fixture(scope="module")
def scene_eval3d():
    """The eval3d suite's scene (tests/test_rasterize_eval3d.py:21-64)."""
    rng = np.random.default_rng(3)
    I, N, D = 2, 120, 3
    means = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2.0, 6.0, N)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.25, (N, 3)).astype(np.float32)
    opacities = np.clip(rng.random((I, N)) * 1.2, 0, 1).astype(np.float32)
    colors = rng.random((I, N, D)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (I, 1, 1))
    viewmats[1, :3, 3] = [0.05, -0.03, 0.1]
    Ks = np.zeros((I, 3, 3), np.float32)
    Ks[:, 0, 0] = Ks[:, 1, 1] = 30.0
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = W / 2, H / 2, 1.0
    viewmats, Ks = jnp.asarray(viewmats), jnp.asarray(Ks)
    radii, means2d, depths, _, _ = j_project(jnp.asarray(means), None, jnp.asarray(quats),
                                            jnp.asarray(scales), viewmats, Ks, W, H,
                                            opacities=jnp.asarray(opacities[0]))
    cam = make_camera("pinhole", W, H, focal_lengths=jnp.stack([Ks[:, 0, 0], Ks[:, 1, 1]], -1),
                      principal_points=Ks[:, :2, 2])
    isect, offsets = _isect(means2d, radii, depths, I)
    return dict(means=means, quats=quats, scales=scales, colors=colors, opacities=opacities,
                rays=np.asarray(generate_rays(cam, W, H, viewmats)), offsets=offsets,
                flatten_ids=isect.flatten_ids, n_isects=isect.n_isects,
                bg=rng.random((I, D)).astype(np.float32))


@pytest.mark.parametrize("hit,normals,bg", [(False, False, False), (True, True, True)])
def test_rasterize_eval3d_ref_matches_jax(scene_eval3d, hit, normals, bg):
    s = scene_eval3d
    keys = ("means", "quats", "scales", "colors", "opacities", "rays")
    tail = ("offsets", "flatten_ids", "n_isects")
    kw = dict(use_hit_distance=hit, return_normals=normals)
    want = j_ref3d(*(jnp.asarray(s[k]) for k in keys), W, H, TS, *(s[k] for k in tail), 512,
                   backgrounds=jnp.asarray(s["bg"]) if bg else None, **kw)
    got = t_ref3d(*(_t(s[k]) for k in keys), W, H, TS, *(_t(s[k]) for k in tail), 512,
                  backgrounds=_t(s["bg"]) if bg else None, **kw)
    assert (got[2] is None) == (want[2] is None)
    for a, b in zip(got, want):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    assert float(got[1].mean()) > 0.05
