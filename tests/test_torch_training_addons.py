"""Port parity: the trainer's add-on modules against the JAX package's.

`training/pose.py` (the 6-D rotation, the pose deltas, the trainer's SE(3)
inverse, the appearance head), `training/bilateral_grid.py` (the image and
point slices, the TV loss) and `training/ppisp.py`, on the same numpy
inputs made from a seed, the JAX package's parameters carried across.
Values, and the gradients of a seeded cotangent with respect to every
input (for the SE(3) inverse: the value on rigid poses and the gradient
through the trainer's pose chain, since the port's inverse is also exact
for the normalised COLMAP poses, which the JAX one is not): the pose
functions within 1e-6 absolute, the others within 1e-5 of
each tensor's largest entry (float32 sums in another order: the matrix
products of the MLP and the slice, the SH bases).  Small sizes: grids of
shape 4,4,2 and 16,16,8, images 24x32.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import gsplat_tpu.training as jt

import gsplat_tpu_torch.training as tt
from gsplat_tpu_torch.training import invert_se3


def _vjp_both(jfn, tfn, args, seed=0):
    """(jax out, torch out, jax grads, torch grads) of fn(*args) for a
    seeded cotangent; args are numpy arrays or dicts of them."""
    j_args = jax.tree_util.tree_map(jnp.asarray, args)
    j_out, vjp = jax.vjp(jax.jit(jfn), *j_args)
    cot = np.random.default_rng(seed).standard_normal(np.shape(j_out)).astype(np.float32)
    j_grads = vjp(jnp.asarray(cot))
    leaves, tree = jax.tree_util.tree_flatten(args)
    t_leaves = [torch.tensor(np.asarray(x), requires_grad=True) for x in leaves]
    t_out = tfn(*jax.tree_util.tree_unflatten(tree, t_leaves))
    t_grads = torch.autograd.grad(t_out, t_leaves, torch.from_numpy(cot), allow_unused=True)
    t_grads = [np.zeros_like(np.asarray(x)) if g is None else g.numpy()
               for x, g in zip(leaves, t_grads)]
    return (np.asarray(j_out), t_out.detach().numpy(), jax.tree_util.tree_leaves(j_grads),
            t_grads)


def _close_rel(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=rel * scale, err_msg=what)


def _rigid(rng, n):
    """Random camera-to-world matrices [n, 4, 4]."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = R.reshape(n, 3, 3)
    m[:, :3, 3] = rng.uniform(-3, 3, (n, 3))
    return m.astype(np.float32)


def test_rotation_6d_to_matrix_matches_jax():
    d6 = np.random.default_rng(1).standard_normal((7, 6)).astype(np.float32)
    jo, to, jg, tg = _vjp_both(jt.rotation_6d_to_matrix, tt.rotation_6d_to_matrix, (d6,))
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), rtol=0, atol=1e-6)


def test_apply_pose_deltas_matches_jax():
    rng = np.random.default_rng(2)
    c2w = _rigid(rng, 5)
    deltas = (0.05 * rng.standard_normal((5, 9))).astype(np.float32)
    jo, to, jg, tg = _vjp_both(jt.apply_pose_deltas, tt.apply_pose_deltas, (c2w, deltas))
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    for g, w, what in zip(tg, jg, ("camtoworlds", "deltas")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6, err_msg=what)
    assert tt.init_pose_deltas(3).shape == (3, 9) and not tt.init_pose_deltas(3).any()


def test_invert_se3_matches_the_jax_trainer_on_rigid_poses():
    """The value on rigid transforms, and the gradient through the trainer's
    pose chain invert(apply_pose_deltas(invert(viewmats), deltas)) with
    respect to the deltas, within 1e-6 of the JAX trainer's."""
    from simple_trainer import _invert_se3

    rng = np.random.default_rng(3)
    mats = _rigid(rng, 6)
    jo, to, _, _ = _vjp_both(_invert_se3, invert_se3, (mats,))
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(to @ mats, np.tile(np.eye(4), (6, 1, 1)), atol=1e-5)
    vm = np.linalg.inv(mats).astype(np.float32)
    deltas = (0.05 * rng.standard_normal((6, 9))).astype(np.float32)
    jo, to, jg, tg = _vjp_both(
        lambda v, d: _invert_se3(jt.apply_pose_deltas(_invert_se3(v), d)),
        lambda v, d: invert_se3(tt.apply_pose_deltas(invert_se3(v), d)), (vm, deltas), seed=4)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tg[1], np.asarray(jg[1]), rtol=0, atol=1e-6, err_msg="d/ddeltas")


def test_invert_se3_inverts_the_normalised_colmap_poses():
    """The COLMAP normalisation T (similarity_from_cameras) is a similarity.
    The port's parser divides its scale out of T @ c2w's rotation blocks,
    so its normalised poses are rigid, and there the port's inverse equals
    the JAX trainer's [R^T | -R^T t].  On the similarity poses T @ c2w
    themselves (as examples/datasets/colmap.py:270 keeps them) the port's
    inverse is still exact, where the JAX formula moves each camera to
    t / s^2."""
    from simple_trainer import _invert_se3

    from gsplat_tpu_torch.datasets.colmap import similarity_from_cameras

    c2w = _rigid(np.random.default_rng(5), 4).astype(np.float64)
    c2w[:, :3, 3] *= 7.0
    sim = similarity_from_cameras(c2w) @ c2w  # the normalisation, scale kept
    s = np.linalg.norm(sim[:, :3, 0], axis=1)
    assert np.all(np.abs(s - s[0]) < 1e-9) and s[0] < 0.5  # a similarity, not rigid
    vm = np.linalg.inv(sim).astype(np.float32)
    got = invert_se3(torch.from_numpy(vm)).numpy()
    np.testing.assert_allclose(got, sim, rtol=0, atol=1e-5)
    jax_c2w = np.asarray(_invert_se3(jnp.asarray(vm)))
    np.testing.assert_allclose(jax_c2w[:, :3, 3], sim[:, :3, 3] / s[:, None] ** 2, rtol=1e-4)

    rigid = sim.copy()  # the port parser's normalised poses
    rigid[:, :3, :3] /= s[:, None, None]
    vm = np.linalg.inv(rigid).astype(np.float32)
    got = invert_se3(torch.from_numpy(vm)).numpy()
    np.testing.assert_allclose(got, rigid, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_invert_se3(jnp.asarray(vm))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sh_degree,with_ids", [(0, True), (1, True), (3, True), (3, False)])
def test_apply_appearance_matches_jax(sh_degree, with_ids):
    rng = np.random.default_rng(4)
    C, N, F = 2, 40, 32
    app = {k: np.asarray(v) for k, v in jt.init_appearance(
        jax.random.PRNGKey(0), 3, F, embed_dim=16, sh_degree=3).items()}
    # the head starts at zero; a nonzero last layer and embeddings reach every input
    app["w2"] = (0.3 * rng.standard_normal(app["w2"].shape)).astype(np.float32)
    app["embeds"] = rng.standard_normal(app["embeds"].shape).astype(np.float32)
    app["b0"] = (0.1 * rng.standard_normal(app["b0"].shape)).astype(np.float32)
    feats = rng.random((N, F), dtype=np.float32)
    dirs = rng.standard_normal((C, N, 3)).astype(np.float32)
    ids = np.array([2, 0]) if with_ids else None

    def f(mod):
        return lambda p, x, d: mod.apply_appearance(
            p, x, None if ids is None else (jnp.asarray(ids) if mod is jt
                                            else torch.from_numpy(ids)), d, sh_degree)

    jo, to, jg, tg = _vjp_both(f(jt), f(tt), (app, feats, dirs), seed=5)
    assert to.shape == (C, N, 3)
    _close_rel(to, jo, 1e-5, "colours")
    names = [f"app[{k}]" for k in sorted(app)] + ["features", "dirs"]
    for g, w, what in zip(tg, jg, names):
        if what == "app[embeds]" and not with_ids:
            assert not g.any() and not np.asarray(w).any()
            continue
        _close_rel(g, w, 1e-5, what)


def test_init_appearance_shapes_and_zero_head():
    gen = torch.Generator().manual_seed(0)
    app = tt.init_appearance(gen, 5, 32, embed_dim=16, sh_degree=3)
    want = {k: np.shape(v) for k, v in jt.init_appearance(jax.random.PRNGKey(0), 5, 32).items()}
    assert {k: tuple(v.shape) for k, v in app.items()} == want
    assert not app["w2"].any() and not app["embeds"].any()
    assert float(app["w0"].abs().max()) <= 1.0 / np.sqrt(16 + 32 + 16)


def _grid(rng, n, shape):
    gx, gy, gw = shape
    g = np.asarray(jt.init_bilateral_grids(n, gx, gy, gw))
    return (g + 0.1 * rng.standard_normal(g.shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 4, 2), (16, 16, 8)], ids=["4,4,2", "16,16,8"])
def test_slice_image_matches_jax(shape):
    rng = np.random.default_rng(6)
    grid = _grid(rng, 1, shape)[0]
    rgb = rng.random((24, 32, 3), dtype=np.float32)
    for i in (0, 1):  # the output image, then the affine map
        jo, to, jg, tg = _vjp_both(lambda g, x: jt.bilateral_slice_image(g, x)[i],
                                   lambda g, x: tt.bilateral_slice_image(g, x)[i], (grid, rgb),
                                   seed=7 + i)
        _close_rel(to, jo, 1e-5, f"output {i}")
        for g, w, what in zip(tg, jg, ("grid", "rgb")):
            _close_rel(g, w, 1e-5, f"output {i}: d/d{what}")
    np.testing.assert_array_equal(
        tt.init_bilateral_grids(2, *shape).numpy(), np.asarray(jt.init_bilateral_grids(2, *shape)))


@pytest.mark.parametrize("shape", [(4, 4, 2), (16, 16, 8)], ids=["4,4,2", "16,16,8"])
def test_slice_points_and_total_variation_match_jax(shape):
    rng = np.random.default_rng(8)
    grids = _grid(rng, 3, shape)
    xy = rng.uniform(-0.1, 1.1, (50, 2)).astype(np.float32)  # some beyond the border
    rgb = rng.random((50, 3), dtype=np.float32)
    idx = rng.integers(0, 3, 50).astype(np.int32)
    jo, to, jg, tg = _vjp_both(
        lambda g, p, c: jt.bilateral_slice_points(g, p, c, jnp.asarray(idx))[0],
        lambda g, p, c: tt.bilateral_slice_points(g, p, c, torch.from_numpy(idx))[0],
        (grids, xy, rgb), seed=9)
    _close_rel(to, jo, 1e-5, "points")
    for g, w, what in zip(tg, jg, ("grids", "xy", "rgb")):
        _close_rel(g, w, 1e-5, f"d/d{what}")
    jo, to, jg, tg = _vjp_both(jt.total_variation_loss, tt.total_variation_loss, (grids,))
    _close_rel(to, jo, 1e-5, "tv")
    _close_rel(tg[0], jg[0], 1e-5, "d tv / d grids")


def _ppisp_params(rng, cams, frames):
    p = {k: np.asarray(v) for k, v in jt.init_ppisp(cams, frames).items()}
    return {k: (0.2 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("batched", [True, False])
def test_apply_ppisp_and_its_regularizer_match_jax(batched):
    rng = np.random.default_rng(10)
    params = _ppisp_params(rng, 2, 3)
    img = rng.uniform(-0.05, 1.1, (2, 24, 32, 3)).astype(np.float32)
    cam = np.array([1, 0], np.int32)
    frame = np.array([2, 0], np.int32)
    if not batched:
        img, cam, frame = img[0], cam[:1], frame[:1]
    jo, to, jg, tg = _vjp_both(
        lambda p, x: jt.apply_ppisp(p, x, jnp.asarray(cam), jnp.asarray(frame)),
        lambda p, x: tt.apply_ppisp(p, x, torch.from_numpy(cam).long(),
                                    torch.from_numpy(frame).long()), (params, img), seed=11)
    assert to.shape == img.shape
    _close_rel(to, jo, 1e-5, "image")
    for g, w, what in zip(tg, jg, [f"params[{k}]" for k in sorted(params)] + ["img"]):
        _close_rel(g, w, 1e-5, what)
    jo, to, jg, tg = _vjp_both(jt.ppisp_regularization, tt.ppisp_regularization, (params,))
    _close_rel(to, jo, 1e-5, "regularizer")
    for g, w, what in zip(tg, jg, sorted(params)):
        _close_rel(g, w, 1e-5, f"d reg / d {what}")


def test_identity_ppisp_keeps_the_image_and_the_constant_is_jax_float32():
    from gsplat_tpu.training import ppisp as jp
    from gsplat_tpu_torch.training import ppisp as tp

    assert tp._SP_INV_1 == jp._SP_INV_1
    img = torch.rand((1, 6, 5, 3), generator=torch.Generator().manual_seed(0))
    out = tt.apply_ppisp(tt.init_ppisp(1, 1), img, torch.zeros(1, dtype=torch.long),
                         torch.zeros(1, dtype=torch.long))
    torch.testing.assert_close(out, img, rtol=0, atol=2e-6)


def test_training_export_list_is_the_jax_one():
    assert tt.__all__ == jt.__all__
    assert all(getattr(tt, n, None) is not None for n in tt.__all__)
