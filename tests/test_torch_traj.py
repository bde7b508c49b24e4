"""Port parity: the port's render trajectories (datasets/traj.py) against
examples/datasets/traj.py, on a seeded capture of cameras looking at a
point, within 1e-6; and the trainer's `npz_traj_views` against the JAX
trainer's views."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from datasets import traj as jt  # noqa: E402  examples/datasets/traj.py

from gsplat_tpu_torch.datasets import traj as tt  # noqa: E402


def _poses(n=7, seed=0):
    """Camera-to-world (n, 3, 4) on a noisy arc, looking at the origin."""
    rng = np.random.default_rng(seed)
    th = np.linspace(-0.8, 0.8, n) + 0.05 * rng.standard_normal(n)
    pos = np.stack([3 * np.sin(th), -0.5 + 0.1 * rng.standard_normal(n), -3 * np.cos(th)], 1)
    return np.stack([jt.lookat_matrix(-p, np.array([0.0, -1.0, 0.0]), p) for p in pos])


CASES = {
    "interpolated": lambda m, p: m.generate_interpolated_path(p, 5),
    "interpolated_degree": lambda m, p: m.generate_interpolated_path(p[:3], 4, spline_degree=2),
    "ellipse_z": lambda m, p: m.generate_ellipse_path_z(p, n_frames=12, height=0.3),
    "ellipse_z_varied": lambda m, p: m.generate_ellipse_path_z(p, 9, variation=0.5, phase=0.2),
    "ellipse_y": lambda m, p: m.generate_ellipse_path_y(p, n_frames=12, height=-0.5),
    "spiral": lambda m, p: m.generate_spiral_path(p, np.array([1.5, 9.0]), n_frames=16),
    "focus_point": lambda m, p: m.focus_point(p),
    "average_pose": lambda m, p: m.average_pose(p),
    "lookat_matrix": lambda m, p: m.lookat_matrix(p[0, :, 2], p[0, :, 1], p[0, :, 3]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_trajectory_equals_the_examples_one(name):
    poses = _poses()
    want = CASES[name](jt, poses)
    got = CASES[name](tt, poses)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_npz_path_views_are_the_jax_trainers(tmp_path):
    from test_torch_trainer import _cfg_kw, _tiny_data

    from gsplat_tpu_torch.trainer import Config, Trainer

    data = _tiny_data()
    path = tmp_path / "tiny.npz"
    np.savez(path, **data)
    kw = dict(npz_traj_views=8, npz_eval_every=3)
    from simple_trainer import Config as JConfig
    from simple_trainer import Runner

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GSPLAT_TPU_TEST_DATA", str(path))
        runner = Runner(JConfig(**_cfg_kw(tmp_path / "jax", capacity=512, tb_every=0, **kw)))
    trainer = Trainer(Config(**_cfg_kw(tmp_path / "torch", **kw)), data=data, device="cpu")
    assert trainer.train_views == runner.train_views and trainer.eval_views == runner.eval_views
    assert len(trainer.eval_views) == 3 and len(trainer.train_views) == 5
    np.testing.assert_array_equal(trainer.viewmats, runner.viewmats)
    np.testing.assert_array_equal(trainer.Ks, runner.Ks)
    assert trainer.scene_scale == pytest.approx(runner.scene_scale, rel=1e-6)
