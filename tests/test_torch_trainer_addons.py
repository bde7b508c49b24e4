"""Port parity: the trainer's add-ons against the JAX trainer.

One JAX `Runner` with `pose_opt`, `pose_noise`, `app_opt`, `bilateral_grid`
(4,4,2) and `ppisp` all on, on tests/test_torch_trainer.py's tiny scene
(MCMC, the exact float32 path), and one trace of its training step: SH
degree 1 at steps 1 to 3.  From identical states carried across each
step, the loss within 2e-5 and every gradient (the splats', the screen
gradient, g_pose, g_bil, g_app, g_pp) within tests/test_torch_trainer.py's
band (2e-3 of each tensor's largest entry); then each add-on's Adam step on
the JAX gradients within 1e-5 relative of the JAX step; and the last step
packed (the appearance colours in the bf16-pair carriers) in
tests/test_torch_trainer_packed.py's band of the exact one.  A checkpoint with
every add-on written by either trainer loads in the other.  A short
`train()` writes the trajectory, the compression and, where `tensorboard`
is installed, the event file.
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_trainer import KEYS, _cfg_kw, _tiny_data

from gsplat_tpu_torch.datasets import decode_png
from gsplat_tpu_torch.optimizers import AdamState
from gsplat_tpu_torch.training import apply_pose_deltas, invert_se3
from gsplat_tpu_torch.trainer import Config, Trainer
from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS

ADDONS = dict(pose_opt=True, pose_noise=1e-3, app_opt=True, bilateral_grid=True,
              bilateral_grid_shape="4,4,2", ppisp=True, sh_degree=1, sh_degree_interval=1,
              pack_payload=False, pack_grads=False)
SPLAT_KEYS = KEYS + ("features",)


def test_config_has_every_field_of_the_jax_config_but_the_viewer():
    from simple_trainer import Config as JConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    missing = set(jax_fields) - set(ours)
    assert missing == set()  # the viewer's two fields came last
    for name in set(jax_fields) - missing:
        assert ours[name] == jax_fields[name], name


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner

    out = tmp_path_factory.mktemp("addons")
    path = out / "tiny.npz"
    np.savez(path, **_tiny_data())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GSPLAT_TPU_TEST_DATA", str(path))
        runner = Runner(JConfig(**_cfg_kw(out / "jax", capacity=512, tb_every=0, **ADDONS)))
    trainer = Trainer(Config(**_cfg_kw(out / "torch", tb_every=0, **ADDONS)),
                      data=_tiny_data(), device="cpu")
    return runner, trainer


def _t(x):
    return torch.from_numpy(np.array(x))


def _carry(runner, trainer, params, opt_state, alive, pose, pose_st, bil, bil_st, app, app_st,
           pp, pp_st):
    """The JAX trainer's whole state, splats and add-ons, into the port's."""
    trainer.params = {k: _t(v) for k, v in params.items()}
    trainer.opt_state = AdamState(mu={k: _t(v) for k, v in opt_state.mu.items()},
                                  nu={k: _t(v) for k, v in opt_state.nu.items()},
                                  count=_t(opt_state.count))
    trainer.alive = _t(alive)
    trainer.pose_deltas, trainer.bil_grids = _t(pose), _t(bil)
    trainer.app_params = {k: _t(v) for k, v in app.items()}
    trainer.ppisp_params = {k: _t(v) for k, v in pp.items()}
    for name, st, key in (("pose_opt_state", pose_st, "pose"), ("bil_opt_state", bil_st, "bil"),
                          ("app_opt_state", app_st, "app"), ("ppisp_opt_state", pp_st, "pp")):
        mu, nu = st.mu[key], st.nu[key]
        if not isinstance(mu, dict):
            mu, nu = {key: mu}, {key: nu}
        setattr(trainer, name, AdamState(mu={k: _t(v) for k, v in mu.items()},
                                         nu={k: _t(v) for k, v in nu.items()},
                                         count=_t(st.count)))


def _band(got, want, what):
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max() + 1e-8,
                               err_msg=what)


def test_initial_addons_match_the_jax_trainer(both):
    runner, trainer = both
    np.testing.assert_array_equal(trainer.params["features"].numpy(),
                                  np.asarray(runner.params["features"]))
    np.testing.assert_array_equal(trainer.pose_perturb.numpy(), np.asarray(runner.pose_perturb))
    np.testing.assert_array_equal(trainer.bil_grids.numpy(), np.asarray(runner.bil_grids))
    assert trainer.bil_lr == runner.bil_lr and trainer.lrs == pytest.approx(runner.lrs)
    for k, v in runner.ppisp_params.items():
        np.testing.assert_array_equal(trainer.ppisp_params[k].numpy(), np.asarray(v))
    assert {k: tuple(v.shape) for k, v in trainer.app_params.items()} == {
        k: tuple(v.shape) for k, v in runner.app_params.items()}
    assert not trainer.app_params["w2"].any() and not np.asarray(runner.app_params["w2"]).any()


def test_three_steps_match_the_jax_train_step(both):
    from gsplat_tpu.optimizers import adam_update as j_adam
    from simple_trainer import _invert_se3, apply_pose_deltas as j_apply

    runner, trainer = both
    cfg = runner.cfg
    targets = runner._make_npz_targets()[: len(runner.train_views)]
    vms = jnp.asarray(runner.viewmats[runner.train_views])
    Ks = jnp.asarray(runner.Ks[runner.train_views])
    # the training poses perturbed as both trainers' train() perturbs them
    vms = _invert_se3(j_apply(_invert_se3(vms), runner.pose_perturb))
    t_vms = invert_se3(apply_pose_deltas(invert_se3(_t(runner.viewmats[runner.train_views])),
                                         trainer.pose_perturb))
    np.testing.assert_allclose(t_vms.numpy(), np.asarray(vms), rtol=0, atol=1e-6)
    step_fn = runner.make_train_step(1)  # SH degree 1 at steps 1 to 3: one trace
    update = runner.make_update_step()
    state = [runner.params, runner.opt_state, runner.alive, runner.pose_deltas,
             runner.pose_opt_state, runner.bil_grids, runner.bil_opt_state, runner.app_params,
             runner.app_opt_state, runner.ppisp_params, runner.ppisp_opt_state]
    for step in (1, 2, 3):
        assert trainer.sh_degree_at(step) == 1
        params, opt_state, alive, pose, pose_st, bil, bil_st, app, app_st, pp, pp_st = state
        before = state
        idx = np.array([step % len(runner.train_views)])
        (loss, g_params, g_screen, g_pose, g_bil, g_app, g_pp, radii, visibility,
         overflow) = step_fn(params, opt_state, alive, vms[idx], Ks[idx], targets[idx], pose,
                             jnp.asarray(idx, jnp.int32), bil, app, pp)
        _carry(runner, trainer, *state)
        (t_loss, t_grads, t_screen, t_radii, t_vis, t_over,
         t_addon) = trainer.train_step_addons(
            trainer.params, trainer.alive, _t(vms[idx]), _t(Ks[idx]), _t(targets[idx]), 1,
            step=step, cam_ids=torch.from_numpy(idx))
        assert not bool(overflow) and not bool(t_over)
        np.testing.assert_array_equal(t_radii.numpy(), np.asarray(radii))
        np.testing.assert_array_equal(t_vis.numpy(), np.asarray(visibility))
        assert float(t_loss) == pytest.approx(float(loss), abs=2e-5)
        for k in SPLAT_KEYS:
            _band(t_grads[k].numpy(), g_params[k], f"step {step}: {k}")
        assert not t_grads["shN"].any()  # the appearance head replaces the SH colours
        _band(t_screen.numpy(), g_screen, f"step {step}: screen")
        assert set(t_addon) == {"pose", "bil", "app", "pp"}
        _band(t_addon["pose"].numpy(), g_pose, f"step {step}: g_pose")
        # the other view's row has the regulariser's gradient only
        other = 1 - idx[0]
        torch.testing.assert_close(t_addon["pose"][other],
                                   2 * cfg.pose_opt_reg * trainer.pose_deltas[other])
        _band(t_addon["bil"].numpy(), g_bil, f"step {step}: g_bil")
        for k in g_app:
            _band(t_addon["app"][k].numpy(), g_app[k], f"step {step}: g_app[{k}]")
        for k in g_pp:
            _band(t_addon["pp"][k].numpy(), g_pp[k], f"step {step}: g_pp[{k}]")

        # each add-on's Adam on the JAX gradients against the JAX Adam
        j_grads = {"pose": _t(g_pose), "bil": _t(g_bil),
                   "app": {k: _t(v) for k, v in g_app.items()},
                   "pp": {k: _t(v) for k, v in g_pp.items()}}
        trainer.update_addons(j_grads)
        pd, pose_st = j_adam({"pose": pose}, {"pose": g_pose}, pose_st, {"pose": cfg.pose_opt_lr})
        bg, bil_st = j_adam({"bil": bil}, {"bil": g_bil}, bil_st, {"bil": runner.bil_lr})
        ap, app_st = j_adam({"app": app}, {"app": g_app}, app_st, {"app": cfg.app_opt_lr})
        pu, pp_st = j_adam({"pp": pp}, {"pp": g_pp}, pp_st, {"pp": cfg.ppisp_lr})
        pairs = [("pose", trainer.pose_deltas, pd["pose"]), ("bil", trainer.bil_grids, bg["bil"])]
        pairs += [(f"app[{k}]", trainer.app_params[k], v) for k, v in ap["app"].items()]
        pairs += [(f"pp[{k}]", trainer.ppisp_params[k], v) for k, v in pu["pp"].items()]
        for what, got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9,
                                       err_msg=f"adam step {step}: {what}")
        assert int(trainer.app_opt_state.count) == int(app_st.count) == step
        lr_scale = 0.01 ** (step / cfg.max_steps)
        params, opt_state = update(params, opt_state, g_params, visibility, lr_scale)
        state = [params, opt_state, alive, pd["pose"], pose_st, bg["bil"], bil_st, ap["app"],
                 app_st, pu["pp"], pp_st]
    # the packed payload and gradients (the trainers' default) carry the
    # appearance head's per-camera colours: the last step again, packed, in
    # tests/test_torch_trainer_packed.py's band of the exact step
    _carry(runner, trainer, *before)
    trainer.cfg.pack_payload = trainer.cfg.pack_grads = True
    p_out = trainer.train_step_addons(trainer.params, trainer.alive, _t(vms[idx]), _t(Ks[idx]),
                                      _t(targets[idx]), 1, step=3, cam_ids=torch.from_numpy(idx))
    trainer.cfg.pack_payload = trainer.cfg.pack_grads = False
    assert abs(float(p_out[0]) - float(t_loss)) < 1e-4
    flat = lambda g: {**{k: g[1][k] for k in SPLAT_KEYS}, "screen": g[2], "pose": g[6]["pose"],
                      "bil": g[6]["bil"], **{f"app[{k}]": v for k, v in g[6]["app"].items()},
                      **{f"pp[{k}]": v for k, v in g[6]["pp"].items()}}
    exact = flat((t_loss, t_grads, t_screen, None, None, None, t_addon))
    for k, got in flat(p_out).items():
        got, want = got.numpy(), exact[k].numpy()
        assert np.isfinite(got).all(), k
        scale = max(float(np.abs(want).max()), 1e-6)
        diff = np.abs(got - want)
        assert float((diff > 5e-3 * scale).mean()) < 0.03, (k, diff.max() / scale)
        assert float(diff.max()) < 0.1 * scale, (k, diff.max() / scale)
    runner.params, runner.opt_state = state[0], state[1]
    runner.pose_deltas, runner.pose_opt_state, runner.bil_grids, runner.bil_opt_state = state[3:7]
    runner.app_params, runner.app_opt_state, runner.ppisp_params, runner.ppisp_opt_state = state[7:]


def _addon_arrays(obj):
    """Every add-on value of a trainer, as numpy arrays by checkpoint key."""
    out = {"pose_deltas": obj.pose_deltas, "bil_grids": obj.bil_grids}
    # the JAX trainer nests its moments under "app" and "pp"; the port does not
    unwrap = lambda d: d.get("app", d.get("pp", d))
    for p, m, v, params, st in (("app_", "amu_", "anu_", obj.app_params, obj.app_opt_state),
                                ("isp_", "imu_", "inu_", obj.ppisp_params, obj.ppisp_opt_state)):
        mu, nu = unwrap(st.mu), unwrap(st.nu)
        for k in params:
            out[p + k], out[m + k], out[v + k] = params[k], mu[k], nu[k]
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def test_checkpoints_with_every_addon_load_in_both_trainers(both, tmp_path):
    runner, trainer = both
    # the port's checkpoint in the JAX trainer and in the port
    trainer.cfg.result_dir = str(tmp_path)
    trainer.app_opt_state.mu["w1"].add_(0.5)
    path = trainer._save(4)
    runner._load(path)
    want = _addon_arrays(trainer)
    for k, v in _addon_arrays(runner).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(runner.params["features"]),
                                  trainer.params["features"].numpy())
    again = Trainer(Config(**_cfg_kw(tmp_path / "t2", tb_every=0, ckpt=path, **ADDONS)),
                    data=_tiny_data(), device="cpu")
    for k, v in _addon_arrays(again).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert not again.pose_opt_state.mu["pose"].any() and int(again.bil_opt_state.count) == 0
    assert int(again.app_opt_state.count) == int(trainer.app_opt_state.count) > 0
    for k in SPLAT_KEYS:
        assert torch.equal(again.params[k], trainer.params[k])
        assert torch.equal(again.opt_state.nu[k], trainer.opt_state.nu[k])
    # the JAX trainer's checkpoint in the port
    runner.cfg.result_dir = str(tmp_path / "j")
    os.makedirs(runner.cfg.result_dir, exist_ok=True)
    runner.ppisp_params = {k: v + 0.25 for k, v in runner.ppisp_params.items()}
    runner._save(7, runner.params, runner.alive)
    back = Trainer(Config(**_cfg_kw(tmp_path / "t3", tb_every=0, **ADDONS,
                                    ckpt=str(tmp_path / "j" / "ckpt_7.npz"))),
                   data=_tiny_data(), device="cpu")
    assert back.start_step == 8
    want = _addon_arrays(runner)
    for k, v in _addon_arrays(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_short_train_writes_trajectory_compression_and_tensorboard(tmp_path):
    cfg = Config(**_cfg_kw(tmp_path / "out", strategy="default", max_steps=3, eval_every=3,
                           save_every=3, tb_every=1, tb_save_image=True, render_traj=True,
                           render_traj_path="ellipse", traj_frames=4, compression="png",
                           **{**ADDONS, "pack_payload": True, "pack_grads": True}))
    tr = Trainer(cfg, data=_tiny_data(), device="cpu")
    start = {"pose": tr.pose_deltas.clone(), "bil": tr.bil_grids.clone(),
             "app": tr.app_params["w2"].clone(), "pp": tr.ppisp_params["wb"].clone()}
    tr.train()
    for name, now in (("pose", tr.pose_deltas), ("bil", tr.bil_grids),
                      ("app", tr.app_params["w2"]), ("pp", tr.ppisp_params["wb"])):
        assert torch.isfinite(now).all() and not torch.equal(now, start[name]), name
    out = tmp_path / "out"
    frames = sorted(os.listdir(out / "traj"))
    assert frames == [f"{i:04d}.png" for i in range(4)]
    img = decode_png((out / "traj" / frames[0]).read_bytes())
    assert img.shape == (48, 64, 3) and img.std() > 0
    assert sorted(os.listdir(out / "compression")) == sorted(
        ["meta.json", "means_l.png", "means_u.png", "quats.png", "scales.png", "opacities.png",
         "sh0.png", "shN_codebook.npz", "shN_labels.png"])
    assert (out / "stats" / "train_step0002_rank0.json").exists()
    if importlib.util.find_spec("tensorboard") is not None:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        (events,) = [f for f in os.listdir(out / "tb") if f.startswith("events.out.tfevents")]
        acc = EventAccumulator(str(out / "tb" / events), size_guidance={"images": 0})
        acc.Reload()
        assert {"train/loss", "train/num_GS", "train/mem", "train/steps_per_sec", "train/psnr",
                "heldout/psnr"} <= set(acc.Tags()["scalars"])
        assert [e.step for e in acc.Scalars("train/loss")] == [0, 1, 2]
        image = acc.Images("train/render")[0]  # the target | render canvas
        assert (image.width, image.height) == (128, 48)
        canvas = decode_png(image.encoded_image_string)
        assert canvas.shape == (48, 128, 3) and canvas.std() > 0
    assert tr.writer is None  # closed at the end of train()


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="unknown compression: zip"):
        Trainer(Config(**_cfg_kw(tmp_path, compression="zip")), data=_tiny_data(), device="cpu")
    with pytest.raises(ValueError, match="unknown render_traj_path"):
        Trainer(Config(**_cfg_kw(tmp_path, render_traj=True, render_traj_path="loop")),
                data=_tiny_data(), device="cpu")
    with pytest.raises(ValueError, match="none of the add-ons"):
        Trainer2DGS(Config2DGS(**_cfg_kw(tmp_path, strategy="default", ppisp=True)),
                    data=_tiny_data(), device="cpu")
