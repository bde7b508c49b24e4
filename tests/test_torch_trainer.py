"""Port parity: the trainer against the JAX trainer, step by step.

Both trainers start from the same numpy seed (identical initial parameters
and batch order).  The JAX step runs `Runner.make_train_step` with
`pack_payload=False, pack_grads=False, fixed_batch=True` (Pallas in interpret
mode); the port runs on device="cpu" with its plain kernel versions.

Selective Adam has no bias correction: its first step moves a parameter by
about 3.16 * lr * sign(g) however small g is, so float32 noise around g = 0
sends two implementations opposite ways.  Parameters after real steps are
therefore never compared tightly.  Compared instead: (a) per step, from
identical parameters carried across by `train_state_from_numpy`, the loss
and the gradients; (b) Adam against Adam on the same gradients, tight;
(c) the port's own loss over a few steps, loosely.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from gsplat_tpu_torch.scene import train_state_from_numpy, train_state_to_numpy
from gsplat_tpu_torch.trainer import Config, Trainer, config_from_args

KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")


def _tiny_data():
    """The tiny scene of tests/test_trainer.py:19-38."""
    rng = np.random.default_rng(0)
    n = 200
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    colors = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    viewmats[:, :3, 3] = rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32)
    viewmats[:, 2, 3] += 4.0
    Ks = np.tile(np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32), (3, 1, 1))
    return dict(means3d=means, colors=colors, viewmats=viewmats, Ks=Ks,
                width=np.int64(64), height=np.int64(48))


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tiny.npz"
    np.savez(path, **_tiny_data())
    return str(path)


def _cfg_kw(result_dir, **kw):
    base = dict(strategy="mcmc", data="npz", result_dir=str(result_dir), max_steps=6,
                batch_size=1, sh_degree=1, sh_degree_interval=2, isect_capacity=1 << 14,
                cap_max=512, refine_every=3, eval_every=6, save_every=6, fixed_batch=True)
    base.update(kw)
    return base


def _jax_flat(runner):
    """The JAX runner's training state in the checkpoint's flat layout."""
    flat = {"alive": np.asarray(runner.alive), "opt_count": np.asarray(runner.opt_state.count)}
    for k in KEYS:
        flat[f"p_{k}"] = np.asarray(runner.params[k])
        flat[f"mu_{k}"] = np.asarray(runner.opt_state.mu[k])
        flat[f"nu_{k}"] = np.asarray(runner.opt_state.nu[k])
    return flat


@pytest.fixture(scope="module")
def both(tiny_npz, tmp_path_factory):
    os.environ["GSPLAT_TPU_TEST_DATA"] = tiny_npz
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner

    out = tmp_path_factory.mktemp("out")
    runner = Runner(JConfig(**_cfg_kw(out / "jax", capacity=512, pack_payload=False,
                                      pack_grads=False, tb_every=0)))
    trainer = Trainer(Config(**_cfg_kw(out / "torch")), data=_tiny_data(), device="cpu")
    return runner, trainer


def test_initial_state_and_targets_match_the_jax_trainer(both):
    runner, trainer = both
    for k in KEYS:
        np.testing.assert_array_equal(trainer.params[k].numpy(), np.asarray(runner.params[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(trainer.alive.numpy(), np.asarray(runner.alive))
    assert trainer.scene_scale == pytest.approx(runner.scene_scale, rel=1e-6)
    for k, lr in runner.lrs.items():
        assert trainer.lrs[k] == pytest.approx(lr, rel=1e-6)
    jt = np.asarray(runner._make_npz_targets())
    tt = trainer._make_npz_targets().numpy()
    assert tt.shape == jt.shape == (3, 48, 64, 3)
    # The forward band of tests/test_torch_rasterize.py (the Pallas scan's
    # ~1e-4-class noise against the port's serial product), with a wider hard
    # bound: the targets are opaque (opacity 0.9), most pixels saturate, and
    # at the stop rule one ulp of T keeps or drops a whole gaussian's weight
    # (measured max 6e-4 on this scene).
    diff = np.abs(tt - jt)
    assert (diff > 3e-5).mean() < 0.05 and diff.max() < 2e-3


def test_three_steps_match_the_jax_train_step(both):
    """Loss and gradients per step from identical parameters; then the
    port's Adam on the JAX gradients against the JAX update, tight."""
    runner, trainer = both
    cfg = runner.cfg
    targets = runner._make_npz_targets()[: len(runner.train_views)]
    vms = jnp.asarray(runner.viewmats[runner.train_views])
    Ks = jnp.asarray(runner.Ks[runner.train_views])
    t_targets = torch.from_numpy(np.array(targets))
    update = runner.make_update_step()
    steps = {}
    params, opt_state, alive = runner.params, runner.opt_state, runner.alive
    dummy = jnp.zeros((1,), jnp.float32)
    for step in range(3):
        sh = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        if sh not in steps:  # one trace per SH degree
            steps[sh] = runner.make_train_step(sh)
        idx = np.array([step % len(runner.train_views)])
        (loss, g_params, g_screen, _, _, _, _, radii, visibility, overflow) = steps[sh](
            params, opt_state, alive, vms[idx], Ks[idx], targets[idx], runner.pose_deltas,
            jnp.asarray(idx, jnp.int32), dummy, dummy, dummy,
        )
        runner.params, runner.opt_state, runner.alive = params, opt_state, alive
        state = train_state_from_numpy(_jax_flat(runner), device="cpu")
        t_loss, t_grads, t_screen, t_radii, t_vis, t_over = trainer.train_step(
            state.params, state.alive, torch.from_numpy(np.asarray(vms[idx])),
            torch.from_numpy(np.asarray(Ks[idx])), t_targets[idx], sh,
        )
        assert trainer.sh_degree_at(step) == sh
        assert not bool(overflow) and not bool(t_over)
        np.testing.assert_array_equal(t_radii.numpy(), np.asarray(radii))
        np.testing.assert_array_equal(t_vis.numpy(), np.asarray(visibility))
        # the loss is a mean over 9,216 values each within the forward band
        assert float(t_loss) == pytest.approx(float(loss), abs=2e-5)
        # Gradients: sums over pixels and slots in another order, and the
        # Pallas scan's noise; relative to each tensor's largest entry (the
        # loss is a mean, so the entries are small), 2e-3 of it.  The floor
        # of 1e-8 is for the quaternions: the initial scales are isotropic,
        # so their true gradient is zero and both sides hold ~1e-9 of
        # cancellation noise.
        # A colour component that is exactly 0 (a 0 among the uint8 colours)
        # sits on the kink of clamp(sh + 0.5, min=0), where one rounding of
        # the SH sum decides between gradient 1 and 0: not compared.
        on_kink = np.abs(np.asarray(params["sh0"]) * 0.28209479177387814 + 0.5) < 1e-6
        for k in KEYS:
            want = np.asarray(g_params[k])
            got = t_grads[k].numpy()
            assert np.isfinite(got).all()
            if k in ("sh0", "shN"):  # [cap, 1, 3] covers every band of the channel
                assert 0 < on_kink.sum() < 10
                got, want = np.where(on_kink, 0.0, got), np.where(on_kink, 0.0, want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-3 * np.abs(want).max() + 1e-8,
                                       err_msg=f"step {step}: {k}")
        want = np.asarray(g_screen)
        np.testing.assert_allclose(t_screen.numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max(), err_msg="screen gradient")
        if sh == 0:
            assert (t_grads["shN"] == 0).all()

        # Adam against Adam on the same (JAX) gradients
        lr_scale = 0.01 ** (step / cfg.max_steps)
        params, opt_state = update(params, opt_state, g_params, visibility, lr_scale)
        j_grads = {k: torch.from_numpy(np.asarray(g_params[k])) for k in KEYS}
        t_params, t_opt = trainer.update(state.params, state.opt_state, j_grads,
                                         torch.from_numpy(np.asarray(visibility)), lr_scale)
        for k in KEYS:
            # one float32 rounding of lr * m / (sqrt(v) + eps) apart
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(params[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"adam step {step}: {k}")
            np.testing.assert_allclose(t_opt.mu[k].numpy(), np.asarray(opt_state.mu[k]),
                                       rtol=1e-6, atol=1e-12)
        assert int(t_opt.count) == int(opt_state.count) == step + 1


def test_six_step_smoke_with_refine_and_noise(tmp_path):
    """The port's own loop: refine and noise run, the model stays finite, the
    loss on a view falls, the outputs are written."""
    cfg = Config(**_cfg_kw(tmp_path / "out", opacity_reg=0.01, scale_reg=0.01))
    trainer = Trainer(cfg, data=_tiny_data(), device="cpu")
    trainer.strategy = trainer.strategy.__class__(cap_max=512, refine_every=3,
                                                  refine_start_iter=1)
    h = []
    run_step, update = trainer.run_step, trainer.update

    def checked_update(params, opt_state, grads, *rest):
        h.append(dict(grads_finite=all(bool(torch.isfinite(g).all()) for g in grads.values())))
        return update(params, opt_state, grads, *rest)

    def recorded_step(*args):
        out = run_step(*args)
        h[-1].update(out, loss=float(out["loss"]), overflow=bool(out["overflow"]),
                     n_alive=int(trainer.alive.sum()))
        return out

    trainer.update, trainer.run_step = checked_update, recorded_step
    # the images of every view, rendered by the caller: train() must not need its own
    params, alive = trainer.train(targets=trainer._make_npz_targets())
    assert [r["step"] for r in h] == list(range(6))
    assert [r["sh_degree"] for r in h] == [0, 0, 1, 1, 1, 1]
    assert [r["view"] for r in h] == [0, 1, 0, 1, 0, 1]
    assert [r["refined"] for r in h] == [False, False, False, True, False, False]
    assert all(r["noised"] and r["grads_finite"] and not r["overflow"] for r in h)
    assert all(np.isfinite(r["loss"]) for r in h)
    assert h[4]["loss"] < h[0]["loss"] and h[5]["loss"] < h[1]["loss"]  # same views
    assert int(alive.sum()) >= 200 and h[3]["n_alive"] >= h[2]["n_alive"]
    assert all(torch.isfinite(v).all() for v in params.values())
    assert (tmp_path / "out" / "stats.jsonl").exists()
    assert (tmp_path / "out" / "ckpt_5.npz").exists()


def test_checkpoints_load_in_both_trainers(both, tmp_path):
    runner, trainer = both
    # the port's checkpoint in the port and in the JAX trainer
    trainer.cfg.result_dir = str(tmp_path)
    trainer.opt_state.mu["means"].add_(0.25)
    path = trainer._save(4)
    again = Trainer(Config(**_cfg_kw(tmp_path / "t2", ckpt=path)), data=_tiny_data(),
                    device="cpu")
    assert again.start_step == 5
    for k in KEYS:
        assert torch.equal(again.params[k], trainer.params[k])
        assert torch.equal(again.opt_state.mu[k], trainer.opt_state.mu[k])
    runner._load(path)
    assert runner.start_step == 5
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(runner.params[k]), trainer.params[k].numpy())
        np.testing.assert_array_equal(np.asarray(runner.opt_state.mu[k]),
                                      trainer.opt_state.mu[k].numpy())
    # the JAX trainer's checkpoint in the port
    runner.cfg.result_dir = str(tmp_path / "j")
    os.makedirs(runner.cfg.result_dir, exist_ok=True)
    runner._save(7, runner.params, runner.alive)
    back = Trainer(Config(**_cfg_kw(tmp_path / "t3", ckpt=str(tmp_path / "j" / "ckpt_7.npz"))),
                   data=_tiny_data(), device="cpu")
    assert back.start_step == 8
    for k in KEYS:
        np.testing.assert_array_equal(back.params[k].numpy(), np.asarray(runner.params[k]))
    # and the flat layout round-trips through scene/convert.py
    flat = train_state_to_numpy(back.params, back.alive, back.opt_state)
    state = train_state_from_numpy(flat, device="cpu")
    assert all(torch.equal(state.params[k], back.params[k]) for k in KEYS)
    assert torch.equal(state.alive, back.alive)
    assert int(state.opt_state.count) == int(back.opt_state.count)


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="'default' or 'mcmc'"):
        Trainer(Config(strategy="adc", result_dir=str(tmp_path)), data=_tiny_data(),
                device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(Config(data="colmap", result_dir=str(tmp_path)), data=_tiny_data(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(result_dir=str(tmp_path)), data=_tiny_data())


def test_cli_parses_the_config():
    cfg, device = config_from_args(["mcmc", "--data", "npz", "--max_steps", "7", "--device",
                                    "cpu", "--fixed_batch", "true", "--means_lr", "1e-3"])
    assert (cfg.max_steps, device, cfg.fixed_batch, cfg.means_lr) == (7, "cpu", True, 1e-3)
    assert cfg.opacity_reg == 0.01 and cfg.scale_reg == 0.01  # the mcmc defaults
    cfg, _ = config_from_args(["--capacity", "900", "--grow_grad2d", "1e-3"])
    assert (cfg.strategy, cfg.capacity, cfg.grow_grad2d, cfg.opacity_reg) == ("default", 900,
                                                                              1e-3, 0.0)


def test_default_strategy_is_the_default_and_its_state_survives_a_checkpoint(tmp_path):
    """The JAX trainer's default (simple_trainer.py:65); its state, with the
    float scene_scale, is written with the checkpoint and restored from it
    (simple_trainer.py:1211-1216)."""
    cfg = Config(**{**_cfg_kw(tmp_path / "a"), "strategy": Config().strategy})
    assert cfg.strategy == "default"
    tr = Trainer(cfg, data=_tiny_data(), device="cpu")
    assert tr.capacity == 6 * 200 and isinstance(tr.strategy_state["scene_scale"], float)
    tr.strategy_state["grad2d"][:5] = torch.arange(5.0)
    tr.strategy_state["count"][:5] = 3.0
    path = tr._save(2)
    again = Trainer(Config(**{**_cfg_kw(tmp_path / "b", ckpt=path), "strategy": "default"}),
                    data=_tiny_data(), device="cpu")
    assert again.start_step == 3
    for k in ("grad2d", "count"):
        assert torch.equal(again.strategy_state[k], tr.strategy_state[k])
    assert again.strategy_state["scene_scale"] == pytest.approx(tr.scene_scale)
