"""Port parity: one packed training step against the JAX trainer.

Both trainers at their defaults, `pack_payload=True, pack_grads=True`
(examples/simple_trainer.py:92-93; the port's Config): the sort carries the
bf16-pair payload and K2 the bf16-pair per-slot gradients.  From identical
parameters (carried across by `train_state_from_numpy`) the loss and the
gradients of one MCMC step are compared, then one update of each from the
JAX gradients, through `train_state_to_numpy`.

Tolerances: the JAX packed kernels evaluate sigma as an expanded quadratic
with a faithful 2-split (tests/test_torch_packed.py says more), about 1e-3 of
a pixel at tile 16 where the port's float32 composite of the same carriers
has rounding only; the loss is a mean over 9,216 values, so 1e-4.  The
gradients are held to the JAX suite's pack_grads band
(tests/test_rasterize_pallas.py:288-295), relative to each tensor's largest
entry.  The update on the same gradients is one float32 rounding apart, as
in tests/test_torch_trainer.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_trainer import KEYS, _cfg_kw, _jax_flat, _tiny_data

from gsplat_tpu_torch.scene import train_state_from_numpy, train_state_to_numpy
from gsplat_tpu_torch.trainer import Config, Trainer


def test_one_packed_step_matches_the_jax_trainer(tmp_path, monkeypatch):
    path = tmp_path / "tiny.npz"
    np.savez(path, **_tiny_data())
    monkeypatch.setenv("GSPLAT_TPU_TEST_DATA", str(path))
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner

    runner = Runner(JConfig(**_cfg_kw(tmp_path / "jax", capacity=512, tb_every=0)))
    trainer = Trainer(Config(**_cfg_kw(tmp_path / "torch")), data=_tiny_data(), device="cpu")
    assert runner.cfg.pack_payload and runner.cfg.pack_grads
    assert trainer.cfg.pack_payload and trainer.cfg.pack_grads

    targets = runner._make_npz_targets()[: len(runner.train_views)]
    np.testing.assert_allclose(trainer._make_npz_targets()[:2].numpy(), np.asarray(targets),
                               atol=2e-3, rtol=0)  # the targets stay exact in both
    idx = np.array([0])
    vms = jnp.asarray(runner.viewmats[idx])
    Ks = jnp.asarray(runner.Ks[idx])
    dummy = jnp.zeros((1,), jnp.float32)
    (loss, g_params, g_screen, *_, radii, visibility, overflow) = runner.make_train_step(0)(
        runner.params, runner.opt_state, runner.alive, vms, Ks, targets[idx], runner.pose_deltas,
        jnp.asarray(idx, jnp.int32), dummy, dummy, dummy,
    )
    state = train_state_from_numpy(_jax_flat(runner), device="cpu")
    t_loss, t_grads, t_screen, t_radii, t_vis, t_over = trainer.train_step(
        state.params, state.alive, torch.from_numpy(np.asarray(vms)),
        torch.from_numpy(np.asarray(Ks)), torch.from_numpy(np.array(targets[idx])), 0,
    )
    assert not bool(overflow) and not bool(t_over)
    np.testing.assert_array_equal(t_radii.numpy(), np.asarray(radii))
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(visibility))
    assert abs(float(t_loss) - float(loss)) < 1e-4
    on_kink = np.abs(np.asarray(runner.params["sh0"]) * 0.28209479177387814 + 0.5) < 1e-6
    for k, got, want in [(k, t_grads[k].numpy(), np.asarray(g_params[k])) for k in KEYS] + [
            ("means2d", t_screen.numpy(), np.asarray(g_screen))]:
        assert np.isfinite(got).all(), k
        if k in ("sh0", "shN"):  # the clamp kink of tests/test_torch_trainer.py
            got, want = np.where(on_kink, 0.0, got), np.where(on_kink, 0.0, want)
        if k == "shN":  # SH degree 0: no gradient in either
            assert (got == 0).all() and (want == 0).all(), k
            continue
        # the floor is for the quaternions: the initial scales are isotropic,
        # so their true gradient is zero and both sides hold ~1e-9 of noise
        scale = max(float(np.abs(want).max()), 1e-6)
        diff = np.abs(got - want)
        assert float((diff > 5e-3 * scale).mean()) < 0.03, (k, diff.max() / scale)
        assert float(diff.max()) < 0.1 * scale, (k, diff.max() / scale)

    # one update of each from the JAX gradients, compared in the checkpoint layout
    params, opt_state = runner.make_update_step()(runner.params, runner.opt_state, g_params,
                                                  visibility, 1.0)
    runner.params, runner.opt_state = params, opt_state
    j_grads = {k: torch.from_numpy(np.asarray(g_params[k])) for k in KEYS}
    t_params, t_opt = trainer.update(state.params, state.opt_state, j_grads,
                                     torch.from_numpy(np.asarray(visibility)), 1.0)
    flat = train_state_to_numpy(t_params, state.alive, t_opt)
    want = _jax_flat(runner)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(flat[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
