"""Port parity: the 2DGS projection and the depth-normal geometry against
gsplat_tpu, on the scene of tests/test_2dgs.py.

Tolerances: radii exact; means2d, depths, ray transforms and normals within
1e-5 of each tensor's largest entry (the two libraries sum the 3x3 products
in another order); gradients within 1e-4 of each input's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.projection2d import fully_fused_projection_2dgs as jproj
from gsplat_tpu.rendering import rasterization_2dgs as j_rast2d
from gsplat_tpu.utils.geometry import depth_to_normal as j_depth_to_normal
from gsplat_tpu.utils.geometry import depth_to_points as j_depth_to_points
from gsplat_tpu_torch.ops.projection2d import GAUSSIAN_EXTEND_2D, fully_fused_projection_2dgs
from gsplat_tpu_torch.rendering import rasterization_2dgs
from gsplat_tpu_torch.utils import depth_to_normal, depth_to_points

W, H = 64, 48


def surfel_scene(seed=5, N=250, C=2):
    """tests/test_2dgs.py's scene as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2, 8, N)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.5 + 0.1).astype(np.float32)
    opacities = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[1, :3, 3] = [0.2, -0.1, 0.4]
    Ks = np.array([[[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]]] * C, np.float32)
    return dict(means=means, quats=quats, scales=scales, opacities=opacities, colors=colors,
                viewmats=viewmats, Ks=Ks)


ARGS = ("means", "quats", "scales", "viewmats", "Ks")


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def test_projection2d_matches_jax():
    s = surfel_scene()
    want = jproj(*(jnp.asarray(s[k]) for k in ARGS), W, H)
    got = fully_fused_projection_2dgs(*(torch.from_numpy(s[k]) for k in ARGS), W, H)
    names = ("radii", "means2d", "depths", "ray_transforms", "normals")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32 and int((got[0] > 0).sum()) > 100
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, 1e-5, name)
    assert GAUSSIAN_EXTEND_2D == 3.33


def test_projection2d_gradients_match_jax():
    s = surfel_scene(seed=8, N=120)
    rng = np.random.default_rng(1)
    C, N = 2, 120
    w_m2, w_d = rng.standard_normal((C, N, 2)), rng.standard_normal((C, N))
    w_M, w_n = rng.standard_normal((C, N, 3, 3)), rng.standard_normal((C, N, 3))
    weights = [x.astype(np.float32) for x in (w_m2, w_d, w_M, w_n)]

    def jloss(means, quats, scales):
        _, m2, d, M, n = jproj(means, quats, scales, *(jnp.asarray(s[k]) for k in ARGS[3:]), W, H)
        return sum(jnp.sum(x * w) for x, w in zip((m2, d, M, n), weights))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(s[k]) for k in ARGS[:3]))
    xs = [torch.from_numpy(s[k]).requires_grad_() for k in ARGS[:3]]
    _, m2, d, M, n = fully_fused_projection_2dgs(*xs, *(torch.from_numpy(s[k]) for k in ARGS[3:]),
                                                  W, H)
    sum((x * torch.from_numpy(w)).sum() for x, w in zip((m2, d, M, n), weights)).backward()
    for name, x, w in zip(ARGS, xs, want):
        _close(x.grad.numpy(), w, 1e-4, f"d/d{name}")


def test_culled_surfels_give_zero_gradients():
    """An edge-on surfel (d == 0 exactly: its u axis along the view ray) and
    one behind the camera are culled; the render's gradient reaches neither,
    and every gradient is finite, in both packages."""
    s = surfel_scene(N=40)
    s["means"][0] = [0.0, 0.0, 1.0]
    s["quats"][0] = [0.5, -0.5, -0.5, -0.5]  # local x -> camera z, local y -> camera x
    s["scales"][0] = [1.0, 0.3, 0.2]
    s["means"][1] = [0.0, 0.0, -2.0]
    s["viewmats"][1] = np.eye(4, dtype=np.float32)
    radii = fully_fused_projection_2dgs(*(torch.from_numpy(s[k]) for k in ARGS), W, H)[0]
    assert (radii[:, :2] == 0).all() and int((radii > 0).all(-1).sum()) > 10

    xs = [torch.from_numpy(s[k]).requires_grad_() for k in ("means", "quats", "scales")]
    out = rasterization_2dgs(*xs, torch.from_numpy(s["opacities"]), torch.from_numpy(s["colors"]),
                             torch.from_numpy(s["viewmats"]), torch.from_numpy(s["Ks"]), W, H,
                             render_mode="RGB+ED")
    (out[0].square().mean() + out[4].mean()).backward()

    def jloss(means, quats, scales):
        o = j_rast2d(means, quats, scales, jnp.asarray(s["opacities"]), jnp.asarray(s["colors"]),
                     jnp.asarray(s["viewmats"]), jnp.asarray(s["Ks"]), W, H, render_mode="RGB+ED")
        return jnp.mean(o[0] ** 2) + jnp.mean(o[4])

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(s[k]) for k in ARGS[:3]))
    for x, w in zip(xs, want):
        g = x.grad.numpy()
        assert np.isfinite(g).all() and (g[:2] == 0).all()
        assert np.isfinite(np.asarray(w)).all()
        _close(g, w, 2e-3, "render gradient")


@pytest.mark.parametrize("z_depth", [True, False])
def test_depth_geometry_matches_jax(z_depth):
    rng = np.random.default_rng(2)
    depths = rng.uniform(2.0, 3.0, (2, H, W, 1)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[1, :3, :3] = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    c2w[:, :3, 3] = rng.standard_normal((2, 3)).astype(np.float32)
    Ks = surfel_scene()["Ks"]
    args_j = tuple(map(jnp.asarray, (depths, c2w, Ks)))
    args_t = tuple(map(torch.from_numpy, (depths, c2w, Ks)))
    _close(depth_to_points(*args_t, z_depth=z_depth).numpy(),
           j_depth_to_points(*args_j, z_depth=z_depth), 1e-6, "points")
    got = depth_to_normal(*args_t, z_depth=z_depth).numpy()
    want = np.asarray(j_depth_to_normal(*args_j, z_depth=z_depth))
    assert got.shape == (2, H, W, 3) and (got[:, 0] == 0).all() and (got[:, :, -1] == 0).all()
    # unit normals of noisy depth differences: differences of nearby
    # points cancel, so the band is that of the points' rounding
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
