"""Port parity: the losses of gsplat_tpu/losses.py (l1, mse, SSIM, and the
23 more of the public surface with LinearLambdaScheduler) and
gsplat_tpu/color_correct.py, values and gradients.

Tolerance 1e-6 absolute on l1, mse and SSIM (means over float32 images; the
blur is the same 11-tap separable convolution in float32 in both), 2e-6
relative to the largest entry on their gradients; 1e-5 relative on the
other losses' values and gradients (reductions of float32 sums in another
order); colour correction within 1e-5 (affine) and 2e-4 (quadratic: the JAX
package solves normal equations with 1e-6 on the diagonal, the port
torch.linalg.lstsq).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import color_correct as jcc
from gsplat_tpu import losses as jl
from gsplat_tpu_torch import color_correct as tcc
from gsplat_tpu_torch import losses as tl


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss", "ssim", "ssim_loss"])
@pytest.mark.parametrize("shape", [(2, 24, 31, 3), (17, 9, 1)])
def test_loss_and_gradient_match_jax(name, shape):
    a, b = _images(0, shape)
    jf, tf = getattr(jl, name), getattr(tl, name)
    want, g_want = jax.value_and_grad(lambda x: jf(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_()
    got = tf(x, torch.from_numpy(b))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-6)
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=0, atol=2e-6 * np.abs(g_want).max())


def test_blur_is_zero_padded_and_separable():
    img = np.random.default_rng(1).random((1, 20, 23, 2)).astype(np.float32)
    w = tl._ssim_window(11)
    assert w.shape == (11,) and w.sum() == pytest.approx(1.0) and w.argmax() == 5
    got = tl._blur2d(torch.from_numpy(img), w).numpy()
    want = np.asarray(jl._blur2d(jnp.asarray(img), jl._ssim_window(11, "float32")))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the border sees zeros: a constant image blurs to less than itself there
    ones = tl._blur2d(torch.ones(1, 20, 23, 1), w)
    assert float(ones[0, 10, 11, 0]) == pytest.approx(1.0, abs=1e-6) and float(ones[0, 0, 0, 0]) < 0.5


def test_ssim_identical_flat_and_window_size():
    a, b = _images(2, (1, 16, 16, 3))
    assert float(tl.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)
    flat = torch.full((1, 16, 16, 3), 0.3)
    # flat images: the variance clamp keeps SSIM <= 1
    assert float(tl.ssim(flat, flat)) <= 1.0 + 1e-6
    for ws in (5, 7):
        want = float(jl.ssim(jnp.asarray(a), jnp.asarray(b), ws))
        assert float(tl.ssim(torch.from_numpy(a), torch.from_numpy(b), ws)) == pytest.approx(want, abs=1e-6)


def test_blur_leaves_the_tf32_setting_alone():
    before = torch.backends.cudnn.allow_tf32
    tl._blur2d(torch.rand(1, 12, 12, 3), tl._ssim_window(11))
    assert torch.backends.cudnn.allow_tf32 == before


def _r(seed, *shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


_IMG = (2, 20, 23, 3)
# name -> (differentiated inputs, fixed inputs, keyword arguments)
LOSS_CASES = {
    "depth_l1_loss": ((_r(1, 2, 20, 23, 1, lo=-0.5, hi=4.0),), (_r(2, 2, 20, 23, 1, lo=-0.5, hi=4.0),),
                      dict(scene_scale=2.5)),
    "pearson_depth_loss": ((_r(3, 20, 23),), (_r(4, 20, 23),), {}),
    "masked_l1": ((_r(5, *_IMG),), (_r(6, *_IMG), _r(7, 2, 20, 23, 1) > 0.4), {}),
    "masked_ssim": ((_r(8, *_IMG),), (_r(9, *_IMG), _r(10, 2, 20, 23, 1) > 0.3), {}),
    "total_variation_loss": ((_r(11, *_IMG),), (), {}),
    "opacity_reg_loss": ((_r(12, 50, lo=-1),), (), {}),
    "scale_reg_loss": ((_r(13, 50, 3, lo=-1),), (), {}),
    "cross_entropy_loss": ((_r(14, 30, 5, lo=-3, hi=3),), (np.random.default_rng(15).integers(
        0, 5, 30).astype(np.int32),), {}),
    "depth_inverse_mse": ((_r(16, 40, lo=0.5, hi=3),), (_r(17, 40, lo=0.5, hi=3),), {}),
    "log_l1": ((_r(18, 40),), (_r(19, 40),), {}),
    "reduce_mean": ((_r(20, 40),), (_r(21, 40) > 0.5,), {}),
    "reduce_quantile": ((_r(22, 203),), (0.7,), {}),
    "reduce_sum": ((_r(23, 40),), (), {}),
    "gaussian_scale_reg": ((_r(24, 50, 3, lo=-1),), (_r(25, 50) > 0.3,), {}),
    "gaussian_density_reg": ((_r(26, 50),), (_r(27, 50) > 0.3,), {}),
    "gaussian_z_scale_reg": ((_r(28, 50),), (0.4,), {}),
    "out_of_bound_loss": ((_r(29, 50, 3, lo=-3, hi=3),), (_r(30, 50, 3, lo=1, hi=4),), {}),
    "binocular_disparity_l1": ((_r(31, 2, 20, 23, 1, lo=-0.2, hi=3),),
                               (_r(32, 2, 20, 23, 1, lo=-0.2, hi=3), _r(33, 2, 20, 23, 1) > 0.2),
                               {}),
    "relu_sum": ((_r(34, 60),), (0.35,), {}),
    "identity_distance": ((_r(35, 2, 12, 4, 5),), (), {}),
    "total_variation_temporal": ((_r(36, 4, 3, 5, 6, 2),), (_r(37, 3),), {}),
}


def _jax_loss(name, diff, fixed, kw):
    f = getattr(jl, name)
    return jax.value_and_grad(lambda *d: jnp.sum(f(*d, *(jnp.asarray(x) if isinstance(
        x, np.ndarray) else x for x in fixed), **kw)), argnums=tuple(range(len(diff))))(
        *map(jnp.asarray, diff))


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_more_losses_match_jax(name):
    diff, fixed, kw = LOSS_CASES[name]
    want, g_want = _jax_loss(name, diff, fixed, kw)
    xs = [torch.from_numpy(d.copy()).requires_grad_() for d in diff]
    fx = [torch.from_numpy(np.asarray(x).copy()) if isinstance(x, np.ndarray) else x for x in fixed]
    got = getattr(tl, name)(*xs, *fx, **kw).sum()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    for x, g in zip(xs, g_want):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-5 * max(np.abs(g).max(), 1e-3))


def test_cross_entropy_with_probabilities_and_weights_reg():
    logits, target = _r(40, 8, 6, lo=-2, hi=2), _r(41, 8, 6)
    target /= target.sum(-1, keepdims=True)
    want = float(jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target)))
    got = float(tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(target)))
    assert got == pytest.approx(want, rel=1e-6)
    ws = [_r(42, 3, 4, 5), _r(43, 2, 7)]
    want = float(jl.weights_reg([jnp.asarray(w) for w in ws]))
    assert float(tl.weights_reg([torch.from_numpy(w) for w in ws])) == pytest.approx(want, rel=1e-6)
    one = _r(44, 1, 3, 4, 5, 2)
    assert torch.equal(tl.total_variation_temporal(torch.from_numpy(one), torch.ones(1)),
                       torch.zeros(1))


@pytest.mark.parametrize("vis", [False, True])
def test_fused_gaussian_losses_match_jax(vis):
    args = (_r(50, 40, 3, lo=-1), _r(51, 40, lo=-1), _r(52, 40), _r(53, 40, 3, lo=-3, hi=3),
            _r(54, 40, 3, lo=1, hi=4))
    v = _r(55, 40) if vis else None
    want = jl.fused_gaussian_losses(*map(jnp.asarray, args), 0.3,
                                    None if v is None else jnp.asarray(v))
    got = tl.fused_gaussian_losses(*map(torch.from_numpy, args), 0.3,
                                   None if v is None else torch.from_numpy(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def test_linear_lambda_scheduler_matches_jax():
    for args in ((0.0, 1.0, 10, 110), (2.0, 0.5, 0, 0)):
        js, ts = jl.LinearLambdaScheduler(*args), tl.LinearLambdaScheduler(*args)
        for step in (-5, 0, 10, 37, 110, 500):
            assert float(ts(step)) == pytest.approx(float(js(step)), abs=1e-7)


def _perturbed(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.05, 0.95, (24, 31, 3)).astype(np.float32)
    img = np.clip(ref * np.array([0.8, 1.1, 0.95], np.float32) + np.array(
        [0.05, -0.02, 0.03], np.float32) + rng.normal(0, 0.01, ref.shape), 0, 1).astype(np.float32)
    return img, ref


def test_color_correct_affine_matches_jax():
    img, ref = _perturbed(60)
    want = np.asarray(jcc.color_correct_affine(jnp.asarray(img), jnp.asarray(ref)))
    x = torch.from_numpy(img).requires_grad_()
    got = tcc.color_correct_affine(x, torch.from_numpy(ref))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    g_want = np.asarray(jax.grad(lambda a: jnp.sum(jcc.color_correct_affine(
        a, jnp.asarray(ref)) ** 2))(jnp.asarray(img)))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=0, atol=1e-5 * np.abs(g_want).max())


def test_color_correct_quadratic_matches_jax():
    img, ref = _perturbed(61)
    want = np.asarray(jcc.color_correct_quadratic(jnp.asarray(img), jnp.asarray(ref)))
    got = tcc.color_correct_quadratic(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert np.abs(got - ref).mean() < np.abs(img - ref).mean()
