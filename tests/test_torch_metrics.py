"""Port parity: training/metrics.py against gsplat_tpu/training/metrics.py.

PSNR within 1e-5 relative; the LPIPS proxy's weights, drawn in numpy as
jax.random draws them, within 1e-6 (a float32 ulp or two: the inverse
error function's log1p); its values and LPIPS(VGG) on a synthetic random
weights file within 1e-5 relative (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.training import metrics as jm
from gsplat_tpu_torch import training as tt
from gsplat_tpu_torch.training import metrics as tm


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_matches():
    a, b = _pair((2, 20, 30, 3))
    want = float(jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert float(tt.psnr(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(want,
                                                                                    rel=1e-5)
    assert float(tt.psnr(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(120.0)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_proxy_weights_are_jax_random_normals(seed):
    want = jm._proxy_weights(seed)
    got = tm.proxy_weights(seed)
    assert [w.shape for w in got] == [(3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 128)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_threefry_split_and_normal_match_jax():
    key = jax.random.PRNGKey(9)
    a, b = jax.random.split(key)
    ta, tb = tm._split((0, 9))
    assert ta == tuple(int(v) for v in jax.random.key_data(a))
    assert tb == tuple(int(v) for v in jax.random.key_data(b))
    want = np.asarray(jax.random.normal(b, (5, 7, 11), jnp.float32))
    np.testing.assert_allclose(tm._normal(tb, (5, 7, 11)), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 37, 45, 3), (33, 20, 3)], ids=["batched", "unbatched"])
def test_lpips_proxy_matches(shape):
    a, b = _pair(shape, seed=3)
    want = np.asarray(jm.lpips_proxy(jnp.asarray(a), jnp.asarray(b)))
    got = tm.lpips_proxy(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    same = tm.lpips_proxy(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same.abs().max()) < 1e-6


def _random_lpips_weights(path, seed=0):
    rng = np.random.default_rng(seed)
    w, cin, ci = {}, 3, 0
    for cout, n in tm._VGG_BLOCKS:
        for _ in range(n):
            w[f"conv{ci}_w"] = (rng.normal(size=(cout, cin, 3, 3))
                                * np.sqrt(2 / (9 * cin))).astype(np.float32)
            w[f"conv{ci}_b"] = rng.normal(0, 0.01, cout).astype(np.float32)
            cin, ci = cout, ci + 1
    for j, (c, _) in enumerate(tm._VGG_BLOCKS):
        w[f"lin{j}_w"] = rng.uniform(0, 1, c).astype(np.float32)
    np.savez(path, **w)


def test_lpips_matches_on_a_random_weights_file(tmp_path):
    path = str(tmp_path / "vgg_lpips.npz")
    _random_lpips_weights(path)
    a, b = _pair((2, 64, 48, 3), seed=4)
    want = np.asarray(jm.lpips(jnp.asarray(a), jnp.asarray(b), path))
    got = tm.lpips(torch.from_numpy(a), torch.from_numpy(b), path).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    w = tt.load_lpips_weights(path)
    assert torch.equal(tm.lpips(torch.from_numpy(a), torch.from_numpy(b), w), torch.from_numpy(got))
