"""Port parity: the trainer on a COLMAP scene against the JAX `Runner` on the
same directory (examples/simple_trainer.py, data="colmap").

A tiny scene is written here: 200 points, 5 views at 64x48 whose PNG
targets the port renders on the CPU (test_every=8 leaves view 0 out of
training).  Its cameras lie 1 from their centroid, so the parsers'
normalisation has scale 1 and both packages' poses are rigid (the port
divides that scale out of the rotation blocks, the JAX parser keeps it).  Held to the JAX runner: the initial parameters, viewmats, Ks,
targets and scene scale (1e-6); per step, from identical parameters, the
loss (2e-5, the band of tests/test_torch_trainer.py); the eval's PSNR, SSIM
and LPIPS proxy on identical parameters (the images are in the forward
band of tests/test_torch_rasterize.py; 1e-3 dB, 2e-5 and 2e-5); its stats
keys; the `.ply` of `save_ply` byte for byte against the JAX exporter.
Both trainers take the exact float32 path (pack_payload and pack_grads
off), as tests/test_torch_trainer.py does.
"""

import json
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from gsplat_tpu import exporter as jexp  # noqa: E402
from gsplat_tpu_torch import rasterization  # noqa: E402
from gsplat_tpu_torch.datasets import encode_png, write_model_binary  # noqa: E402
from gsplat_tpu_torch.scene import load_checkpoint, train_state_from_numpy  # noqa: E402
from gsplat_tpu_torch.trainer import Config, Trainer  # noqa: E402
from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS  # noqa: E402

KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")
W, H, VIEWS = 64, 48, 5


def write_tiny_scene(root):
    """A binary COLMAP model of 200 points seen by 5 cameras on a circle of
    radius 1 around their centroid, and PNG images rendered from those
    points with the port on the CPU."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.25, 0.25, (200, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    vms = []
    for i in range(VIEWS):
        a = 2 * np.pi * i / VIEWS
        eye = np.array([np.cos(a), np.sin(a), 0.25])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, -1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        vm = np.eye(4)
        vm[:3, :3], vm[:3, 3] = R, -R @ eye
        vms.append(vm)
    vms = np.stack(vms)
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
    cams = {1: dict(model="PINHOLE", width=W, height=H, params=np.array([60.0, 60.0, 32, 24]))}
    names = [f"frame_{i:02d}.png" for i in range(VIEWS)]
    write_model_binary(os.path.join(root, "sparse", "0"), cams, vms, [1] * VIEWS, names, pts, rgb)
    n = len(pts)
    with torch.no_grad():
        img, _, _ = rasterization(
            torch.from_numpy(pts), torch.tensor([[1.0, 0, 0, 0]]).expand(n, 4).contiguous(),
            torch.full((n, 3), 0.03), torch.full((n,), 0.9),
            torch.from_numpy(rgb.astype(np.float32) / 255.0),
            torch.from_numpy(vms.astype(np.float32)), torch.from_numpy(np.tile(K, (VIEWS, 1, 1))),
            W, H)
    os.makedirs(os.path.join(root, "images"))
    for name, im in zip(names, img.numpy()):
        with open(os.path.join(root, "images", name), "wb") as f:
            f.write(encode_png(np.round(np.clip(im, 0, 1) * 255).astype(np.uint8)))


def _cfg_kw(data_dir, result_dir, **kw):
    base = dict(strategy="mcmc", data="colmap", data_dir=str(data_dir), factor=1,
                result_dir=str(result_dir), max_steps=3, batch_size=1, sh_degree=1,
                sh_degree_interval=2, isect_capacity=1 << 14, cap_max=512, refine_every=3,
                eval_every=3, save_every=3, fixed_batch=True, pack_payload=False,
                pack_grads=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap")
    write_tiny_scene(str(root))
    return root


@pytest.fixture(scope="module")
def both(scene, tmp_path_factory):
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner

    out = tmp_path_factory.mktemp("out")
    runner = Runner(JConfig(**_cfg_kw(scene, out / "jax", tb_every=0)))
    trainer = Trainer(Config(**_cfg_kw(scene, out / "torch")), device="cpu")
    return runner, trainer


def _jax_targets(runner):
    return np.stack([runner.trainset[i]["image"] for i in range(len(runner.trainset))])


def test_initial_state_cameras_and_targets_match_the_jax_runner(both):
    runner, trainer = both
    assert len(trainer.train_views) == len(runner.trainset) == VIEWS - 1
    np.testing.assert_array_equal(trainer.trainset.indices, [1, 2, 3, 4])
    assert (trainer.width, trainer.height) == (runner.width, runner.height) == (W, H)
    for k in KEYS:
        np.testing.assert_allclose(trainer.params[k].numpy(), np.asarray(runner.params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(trainer.alive.numpy(), np.asarray(runner.alive))
    np.testing.assert_allclose(trainer.viewmats, runner.viewmats, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trainer.Ks, runner.Ks, rtol=0, atol=1e-6)
    assert trainer.scene_scale == pytest.approx(runner.scene_scale, abs=1e-6)
    for k, lr in runner.lrs.items():
        assert trainer.lrs[k] == pytest.approx(lr, rel=1e-6)
    targets = trainer.colmap_targets()
    assert targets.shape == (VIEWS - 1, H, W, 3) and float(targets.mean()) > 0.05
    np.testing.assert_allclose(targets.numpy(), _jax_targets(runner), rtol=0, atol=1e-6)
    assert trainer.lpips_w is None  # no weights file: the eval reports lpips None


def test_steps_and_eval_match_the_jax_runner(both):
    """Per step, from identical parameters, the loss; then the eval of
    both on the parameters the JAX steps reached."""
    runner, trainer = both
    targets = jnp.asarray(_jax_targets(runner))
    vms, Ks = jnp.asarray(runner.viewmats), jnp.asarray(runner.Ks)
    t_targets = torch.from_numpy(np.array(targets))
    update = runner.make_update_step()
    params, opt_state, alive = runner.params, runner.opt_state, runner.alive
    dummy = jnp.zeros((1,), jnp.float32)
    steps = {}
    for step in range(3):
        sh = min(step // 2, 1)
        if sh not in steps:
            steps[sh] = runner.make_train_step(sh)
        idx = np.array([step % len(runner.trainset)])
        loss, g_params, *_, visibility, overflow = steps[sh](
            params, opt_state, alive, vms[idx], Ks[idx], targets[idx], runner.pose_deltas,
            jnp.asarray(idx, jnp.int32), dummy, dummy, dummy)
        flat = {"alive": np.asarray(alive), "opt_count": np.asarray(opt_state.count)}
        flat.update({f"p_{k}": np.asarray(params[k]) for k in KEYS})
        state = train_state_from_numpy(flat, device="cpu")
        t_loss, *_, t_over = trainer.train_step(
            state.params, state.alive, torch.from_numpy(np.array(vms[idx])),
            torch.from_numpy(np.array(Ks[idx])), t_targets[idx], sh)
        assert not bool(overflow) and not bool(t_over)
        assert float(t_loss) == pytest.approx(float(loss), abs=2e-5), f"step {step}"
        params, opt_state = update(params, opt_state, g_params, visibility,
                                   0.01 ** (step / 3))

    runner.params, runner.alive = params, alive
    state = train_state_from_numpy(
        {"alive": np.asarray(alive), **{f"p_{k}": np.asarray(params[k]) for k in KEYS}},
        device="cpu")
    trainer.params, trainer.alive = state.params, state.alive
    j_psnr, j_ssim = runner.eval(2, targets, vms, Ks)
    t_psnr, t_ssim = trainer.eval(2, t_targets, torch.from_numpy(runner.viewmats),
                                  torch.from_numpy(runner.Ks))
    assert t_psnr == pytest.approx(j_psnr, abs=1e-3)
    assert t_ssim == pytest.approx(j_ssim, abs=2e-5)
    j = json.loads(Path(runner.stats_dir, "eval_step0002.json").read_text())
    t = json.loads(Path(trainer.stats_dir, "eval_step0002.json").read_text())
    assert t.keys() == j.keys()
    assert t["lpips"] is None and j["lpips"] is None
    assert t["lpips_proxy"] == pytest.approx(j["lpips_proxy"], abs=2e-5)
    assert (t["tag"], t["step"], t["n_gs"], t["mem"]) == ("eval", 2, j["n_gs"], 0.0)
    line = json.loads(Path(trainer.cfg.result_dir, "stats.jsonl").read_text().splitlines()[-1])
    assert line == t


def test_train_writes_the_eval_and_a_ply_the_jax_exporter_would(scene, tmp_path):
    """The port's own loop on the COLMAP scene: losses finite, the eval of
    the training views under the tag "eval", the `.ply` of the alive rows
    byte for byte as the JAX exporter writes them, served again through
    load_checkpoint."""
    trainer = Trainer(Config(**_cfg_kw(scene, tmp_path / "run", save_ply=True)), device="cpu")
    params, alive = trainer.train()
    assert all(torch.isfinite(v).all() for v in params.values())
    stats = [json.loads(x) for x in (tmp_path / "run" / "stats.jsonl").read_text().splitlines()]
    assert [s["tag"] for s in stats] == ["eval"] and stats[0]["step"] == 2
    assert np.isfinite([stats[0][k] for k in ("psnr", "ssim", "lpips_proxy")]).all()
    assert stats[0]["ellipse_time"] > 0
    ply = tmp_path / "run" / "ply" / "point_cloud_2.ply"
    keep = alive.numpy()
    want = jexp.export_splats(**{k: params[k].numpy()[keep] for k in (
        "means", "scales", "quats", "opacities", "sh0", "shN")}, format="ply")
    assert ply.read_bytes() == want
    g = load_checkpoint(str(ply), device="cpu")
    assert g.num_gaussians == int(keep.sum())
    assert torch.equal(g.splats["means"], params["means"][alive])


def test_surfel_trainer_builds_on_colmap_and_evaluates(scene, tmp_path):
    """Trainer2DGS inherits the COLMAP branch and the eval, as the JAX
    Runner2DGS inherits the base Runner's."""
    tr = Trainer2DGS(Config2DGS(**_cfg_kw(scene, tmp_path / "s", strategy="default")),
                     device="cpu")
    assert tr.capacity == 6 * 200 and len(tr.train_views) == VIEWS - 1
    targets = tr.colmap_targets()
    psnr, ssim = tr.eval(0, targets, torch.from_numpy(tr.viewmats), torch.from_numpy(tr.Ks))
    assert np.isfinite(psnr) and 0 < ssim <= 1
    stats = json.loads((tmp_path / "s" / "stats" / "eval_step0000.json").read_text())
    assert stats["psnr"] == psnr and stats["lpips"] is None
