"""Port parity: the 2DGS trainer and the default strategy in both trainers,
against the JAX runners, step by step.

As in tests/test_torch_trainer.py, each step starts from identical
parameters carried across by train_state_from_numpy, and the loss and the
gradients are compared (the JAX runner in interpret mode, the port on the
CPU); the strategy's statistics accumulate from each side's own screen
gradients; a refine runs on the JAX side's state with the JAX split's own
normal draws handed to the port.
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

from gsplat_tpu_torch.scene import train_state_from_numpy
from gsplat_tpu_torch.trainer import Config, Trainer
from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS

from test_torch_trainer import KEYS, _jax_flat, _tiny_data

ON_KINK = 0.28209479177387814


def _kw(result_dir, **kw):
    base = dict(strategy="default", data="npz", result_dir=str(result_dir), max_steps=6,
                batch_size=1, sh_degree=1, sh_degree_interval=2, isect_capacity=1 << 14,
                capacity=600, refine_every=2, eval_every=6, save_every=6, fixed_batch=True,
                grow_grad2d=2e-5)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    np.savez(out / "tiny.npz", **_tiny_data())
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner
    from simple_trainer_2dgs import Config as J2Config
    from simple_trainer_2dgs import Runner2DGS

    surf = dict(normal_start_iter=0, dist_start_iter=0)
    # the JAX runners read their npz when they are built; the variable must
    # not outlive this fixture, or a later test file finds this tiny scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GSPLAT_TPU_TEST_DATA", str(out / "tiny.npz"))
        j2 = Runner2DGS(J2Config(**_kw(out / "j2", tb_every=0, **surf)))
        j3 = Runner(JConfig(**_kw(out / "j3", tb_every=0, pack_payload=False,
                                  pack_grads=False)))
    t2 = Trainer2DGS(Config2DGS(**_kw(out / "t2", **surf)), data=_tiny_data(), device="cpu")
    # the JAX runner's flags on the port too: its Config packs by default
    t3 = Trainer(Config(**_kw(out / "t3", pack_payload=False, pack_grads=False)),
                 data=_tiny_data(), device="cpu")
    for r, t in ((j2, t2), (j3, t3)):
        schedule = dict(refine_start_iter=1, reset_every=1000)
        r.strategy = r.strategy.__class__(**{**r.strategy.__dict__, **schedule})
        t.strategy = t.strategy.__class__(**{**t.strategy.__dict__, **schedule})
    return {"2dgs": (j2, t2), "3dgs": (j3, t3)}


def _grads_close(got, want, params, what):
    on_kink = np.abs(np.asarray(params["sh0"]) * ON_KINK + 0.5) < 1e-6
    for k in KEYS:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert np.isfinite(g).all(), f"{what}: {k}"
        if k in ("sh0", "shN"):  # the clamp kink of the SH colours (ROADMAP Queue 3)
            g, w = np.where(on_kink, 0.0, g), np.where(on_kink, 0.0, w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * np.abs(w).max() + 1e-8,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("kind", ["2dgs", "3dgs"])
def test_three_default_strategy_steps_match_the_jax_runner(runners, kind):
    """Steps 0 to 2 with a refine at step 2: the loss, the gradients and the
    screen gradient per step; the strategy's statistics; then the refine."""
    runner, trainer = runners[kind]
    cfg = runner.cfg
    assert trainer.capacity == runner.capacity == 600
    assert trainer.strategy.scale_axes == runner.strategy_scale_axes
    targets = runner._make_npz_targets()[: len(runner.train_views)]
    vms = jnp.asarray(runner.viewmats[runner.train_views])
    Ks = jnp.asarray(runner.Ks[runner.train_views])
    t_targets = torch.from_numpy(np.array(targets))
    update = runner.make_update_step()
    params, opt_state, alive = runner.params, runner.opt_state, runner.alive
    jstate = runner.strategy_state
    tstate = trainer.strategy.initialize_state(600, scene_scale=trainer.scene_scale)
    assert tstate["scene_scale"] == pytest.approx(jstate["scene_scale"], rel=1e-6)
    dummy = jnp.zeros((1,), jnp.float32)
    key = jax.random.PRNGKey(0)
    steps = {}
    for step in range(3):
        sh = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        if sh not in steps:
            steps[sh] = runner.make_train_step(sh)
        idx = np.array([step % len(runner.train_views)])
        out = steps[sh](params, opt_state, alive, vms[idx], Ks[idx], targets[idx],
                        runner.pose_deltas, jnp.asarray(idx, jnp.int32), dummy, dummy, dummy)
        loss, g_params, g_screen, radii, visibility = out[0], out[1], out[2], out[-3], out[-2]
        runner.params, runner.opt_state, runner.alive = params, opt_state, alive
        state = train_state_from_numpy(_jax_flat(runner), device="cpu")
        t_loss, t_grads, t_screen, t_radii, t_vis, t_over = trainer.train_step(
            state.params, state.alive, torch.from_numpy(np.array(vms[idx])),
            torch.from_numpy(np.array(Ks[idx])), t_targets[idx], sh, step=step,
        )
        live = np.asarray(alive)
        assert not bool(t_over) and not bool(out[-1])
        np.testing.assert_array_equal(t_radii.numpy()[:, live], np.asarray(radii)[:, live])
        np.testing.assert_array_equal(t_vis.numpy(), np.asarray(visibility))
        assert float(t_loss) == pytest.approx(float(loss), abs=5e-5)
        _grads_close(t_grads, g_params, params, f"{kind} step {step}")
        want = np.asarray(g_screen)
        np.testing.assert_allclose(t_screen.numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max(), err_msg="screen gradient")
        assert np.abs(want).max() > 0

        params, opt_state = update(params, opt_state, g_params, visibility, 0.01 ** (step / 6))
        jstate = runner.strategy.update_state(jstate, g_screen, radii, runner.width,
                                              runner.height, 1)
        trainer.strategy.update_state(tstate, t_screen, t_radii, trainer.width, trainer.height, 1)
        for k in ("grad2d", "count"):
            np.testing.assert_allclose(tstate[k].numpy()[live], np.asarray(jstate[k])[live],
                                       rtol=5e-3, atol=1e-9, err_msg=k)
        assert trainer.strategy.should_refine(step) == runner.strategy.should_refine(step)

    # the refine at step 2, on the JAX side's state
    assert runner.strategy.should_refine(2)
    runner.params, runner.opt_state, runner.alive = params, opt_state, alive
    flat = _jax_flat(runner)
    state = train_state_from_numpy(flat, device="cpu")
    t_jstate = {**{k: torch.from_numpy(np.array(jstate[k])) for k in ("grad2d", "count")},
                "scene_scale": jstate["scene_scale"]}
    jp, (jmu, _), jalive, _ = runner.strategy.refine(params, (opt_state.mu, opt_state.nu), alive,
                                                     jstate, 2, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 600, 3), jnp.float32)))
    tp, (tmu, _), talive, tst = trainer.strategy.refine(
        state.params, (state.opt_state.mu, state.opt_state.nu), state.alive, t_jstate, 2,
        noise=noise)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert int(talive.sum()) > 200
    for k in KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tmu[k].numpy(), np.asarray(jmu[k]), rtol=1e-5, atol=1e-6)
    assert float(tst["count"].sum()) == 0


def test_2dgs_checkpoints_load_in_both_trainers(runners, tmp_path):
    runner, trainer = runners["2dgs"]
    trainer.cfg.result_dir = str(tmp_path)
    trainer.strategy_state["grad2d"].add_(0.5)
    trainer.strategy_state["count"].add_(2.0)
    path = trainer._save(4)
    again = Trainer2DGS(Config2DGS(**_kw(tmp_path / "t", ckpt=path)), data=_tiny_data(),
                        device="cpu")
    assert again.start_step == 5
    for k in ("grad2d", "count"):
        assert torch.equal(again.strategy_state[k], trainer.strategy_state[k])
    assert isinstance(again.strategy_state["scene_scale"], float)
    runner._load(path)
    assert runner.start_step == 5 and isinstance(runner.strategy_state["scene_scale"], float)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(runner.params[k]), trainer.params[k].numpy())
    np.testing.assert_array_equal(np.asarray(runner.strategy_state["grad2d"]),
                                  trainer.strategy_state["grad2d"].numpy())
    # the JAX runner's checkpoint in the port
    runner.cfg.result_dir = str(tmp_path / "j")
    os.makedirs(runner.cfg.result_dir, exist_ok=True)
    runner._save(7, runner.params, runner.alive)
    back = Trainer2DGS(Config2DGS(**_kw(tmp_path / "t3", ckpt=str(tmp_path / "j" / "ckpt_7.npz"))),
                       data=_tiny_data(), device="cpu")
    assert back.start_step == 8
    np.testing.assert_array_equal(back.strategy_state["count"].numpy(),
                                  np.asarray(runner.strategy_state["count"]))
    for k in KEYS:
        np.testing.assert_array_equal(back.params[k].numpy(), np.asarray(runner.params[k]))


def test_2dgs_trainer_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer2DGS(Config2DGS(**_kw(tmp_path)), data=_tiny_data())


def test_2dgs_trainer_runs_its_loop(tmp_path):
    """Six steps of the port's own loop with refines and opacity resets; the
    CLI parses its config."""
    from gsplat_tpu_torch.trainer import config_from_args

    cfg = Config2DGS(**_kw(tmp_path / "out", normal_start_iter=2, dist_start_iter=0))
    tr = Trainer2DGS(cfg, data=_tiny_data(), device="cpu")
    tr.strategy = tr.strategy.__class__(**{**tr.strategy.__dict__, "refine_start_iter": 1,
                                           "reset_every": 4})
    seen = []
    run_step = tr.run_step
    tr.run_step = lambda *a: seen.append(run_step(*a)) or seen[-1]
    params, alive = tr.train()
    assert [r["refined"] for r in seen] == [False, False, True, False, True, False]
    assert [r["reset"] for r in seen] == [False, False, False, False, True, False]
    assert all(np.isfinite(float(r["loss"])) and not bool(r["overflow"]) for r in seen)
    assert int(alive.sum()) > 200 and all(torch.isfinite(v).all() for v in params.values())
    assert (tmp_path / "out" / "ckpt_5.npz").exists()
    cfg, device = config_from_args(["default", "--normal_lambda", "0.1", "--device", "cpu"],
                                   config_cls=Config2DGS)
    assert (cfg.strategy, cfg.normal_lambda, device, cfg.opacity_reg) == ("default", 0.1, "cpu", 0.0)
