"""Port parity: examples/image_fitting_torch.py against examples/image_fitting.py.

The same numpy start (seed 42) and target go to both trainers, at 64x64
with 200 points.  The first 5 steps' losses agree within 1e-4 relative
when each step starts from the same parameters (the JAX trainer's, carried
across: Adam's first steps take the sign of every gradient, so rounding in
a near-zero gradient would otherwise change the path), and the port's own
5 steps from the start give the same first loss and a falling one.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import image_fitting as jfit  # noqa: E402
import image_fitting_torch as tfit  # noqa: E402

from gsplat_tpu.losses import mse_loss  # noqa: E402
from gsplat_tpu.optimizers import adam_init, adam_update  # noqa: E402
from gsplat_tpu_torch.optimizers.adam import AdamState  # noqa: E402

H = W = 64
N = 200


def test_default_target_and_start_are_the_jax_trainer_s():
    np.testing.assert_array_equal(tfit.default_target(H, W), jfit.default_target(H, W))
    gt = jfit.default_target(H, W)
    j, t = jfit.SimpleTrainer(gt, num_points=N), tfit.SimpleTrainer(gt, num_points=N,
                                                                     device="cpu")
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(t.viewmat.numpy(), np.asarray(j.viewmat))
    np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))


def test_first_five_steps_match_the_jax_trainer():
    gt = jfit.default_target(H, W)
    j, t = jfit.SimpleTrainer(gt, num_points=N), tfit.SimpleTrainer(gt, num_points=N,
                                                                     device="cpu")

    @jax.jit
    def step(params, opt_state):  # SimpleTrainer.train's step (examples/image_fitting.py:112-121)
        loss, grads = jax.value_and_grad(lambda p: mse_loss(j.render(p), j.gt_image))(params)
        params, opt_state = adam_update(params, grads, opt_state, 0.01, eps=1e-8)
        return loss, params, opt_state

    params, opt = j.params, adam_init(j.params)
    t_own = tfit.SimpleTrainer(gt, num_points=N, device="cpu")
    own_opt = tfit.adam_init(t_own.params)
    own, jl = [], []
    for it in range(5):
        # the port's step from the JAX trainer's state
        t.params = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
        t_opt = AdamState(mu={k: torch.from_numpy(np.array(v)) for k, v in opt.mu.items()},
                          nu={k: torch.from_numpy(np.array(v)) for k, v in opt.nu.items()},
                          count=torch.from_numpy(np.array(opt.count)))
        t_loss, _ = t.train_step(t_opt)
        j_loss, params, opt = step(params, opt)
        assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-4), it
        jl.append(float(j_loss))
        loss, own_opt = t_own.train_step(own_opt)
        own.append(float(loss))
    assert own[0] == pytest.approx(jl[0], rel=1e-4)
    assert own[-1] < own[0]


def test_train_returns_the_last_loss():
    t = tfit.SimpleTrainer(tfit.default_target(32, 32), num_points=50, device="cpu")
    lines = []
    last = t.train(iterations=3, log=lines.append)
    assert np.isfinite(last) and lines[0].startswith("iter 0: mse") and "total" in lines[-1]
