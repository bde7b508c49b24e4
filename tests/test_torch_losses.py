"""Port parity: l1, mse and SSIM vs gsplat_tpu/losses.py, values and gradients.

Tolerance 1e-6 absolute on the losses (means over float32 images; the blur
is the same 11-tap separable convolution in float32 in both), 2e-6 relative
to the largest entry on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import losses as jl
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
