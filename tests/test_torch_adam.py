"""Port parity: Adam and selective Adam vs gsplat_tpu/optimizers/adam.py on
the same injected numpy gradients.

Tolerance: rtol 1e-6 / atol 1e-9 on moments (one multiply-add each), rtol
2e-6 / atol 1e-8 on parameters (lr * m / (sqrt(v) + eps) is a few float32
roundings, possibly fused differently by XLA).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.optimizers import adam as ja
from gsplat_tpu_torch.optimizers import adam as ta

SHAPES = {"means": (50, 3), "opacities": (50,), "shN": (50, 4, 3)}
LRS = {"means": 1.6e-4, "opacities": 5e-2, "shN": 1.25e-4}


def _state(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _to_torch(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _assert_close(tp, ts, jp, js):
    for k in SHAPES:
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2e-6, atol=1e-8)
    assert int(ts.count) == int(js.count)


@pytest.mark.parametrize("lrs", [LRS, 1e-3], ids=["per-key", "scalar"])
def test_adam_update_matches_jax_over_steps(lrs):
    p0 = _state(0)
    jp, js = _to_jax(p0), ja.adam_init(_to_jax(p0))
    tp = _to_torch(p0)
    ts = ta.adam_init(tp)
    for step in range(4):
        g = _grads(10 + step)
        jp, js = ja.adam_update(jp, _to_jax(g), js, lrs)
        tp, ts = ta.adam_update(tp, _to_torch(g), ts, lrs)
        _assert_close(tp, ts, jp, js)


@pytest.mark.parametrize("with_visibility", [True, False])
def test_selective_adam_matches_jax_over_steps(with_visibility):
    p0 = _state(1)
    jp, js = _to_jax(p0), ja.adam_init(_to_jax(p0))
    tp = _to_torch(p0)
    ts = ta.adam_init(tp)
    rng = np.random.default_rng(2)
    for step in range(4):
        g = _grads(20 + step)
        vis = rng.random(50) < 0.6 if with_visibility else None
        jp, js = ja.selective_adam_update(jp, _to_jax(g), js, LRS,
                                          visibility=None if vis is None else jnp.asarray(vis))
        tp, ts = ta.selective_adam_update(tp, _to_torch(g), ts, LRS,
                                          visibility=None if vis is None else torch.from_numpy(vis))
        _assert_close(tp, ts, jp, js)


def test_selective_adam_has_no_bias_correction_and_skips_the_invisible():
    """The first step moves a visible parameter by lr * 0.1 g / (sqrt(0.001) |g| + eps),
    about 3.16 * lr * sign(g), however small g is; an invisible one keeps its
    parameters and moments, whatever its gradient holds."""
    p = {"x": torch.zeros(4)}
    st = ta.adam_init(p)
    g = {"x": torch.tensor([1e-3, -1e-3, 3.0, float("nan")])}
    vis = torch.tensor([True, True, False, False])
    p, st = ta.selective_adam_update(p, g, st, 0.01, visibility=vis)
    step = 0.01 * 0.1 / np.sqrt(0.001)
    np.testing.assert_allclose(p["x"].numpy(), [-step, step, 0.0, 0.0], rtol=2e-3)
    assert (st.mu["x"][2:] == 0).all() and (st.nu["x"][2:] == 0).all()


def test_updates_are_in_place():
    p = {"x": torch.ones(3)}
    st = ta.adam_init(p)
    ptr, mptr = p["x"].data_ptr(), st.mu["x"].data_ptr()
    p2, st2 = ta.selective_adam_update(p, {"x": torch.ones(3)}, st, 0.1)
    p3, st3 = ta.adam_update(p2, {"x": torch.ones(3)}, st2, 0.1)
    assert p3["x"].data_ptr() == ptr and st3.mu["x"].data_ptr() == mptr
    assert int(st3.count) == 2 and float(p["x"][0]) < 1.0


def test_schedulers_match_jax():
    from gsplat_tpu.training import schedulers as js
    from gsplat_tpu_torch.training import schedulers as tsch

    for step in (0, 1, 2999, 30_000):
        assert tsch.exponential_lr(step, 1.6e-4, 30_000) == pytest.approx(
            float(js.exponential_lr(step, 1.6e-4, 30_000)), rel=1e-6)
        assert tsch.two_stage_lr(step, 1e-3, 3000, 1e-4) == pytest.approx(
            float(js.two_stage_lr(step, 1e-3, 3000, 1e-4)), rel=1e-6)
