"""Port parity: the capture/replay harness and the workload presets
(gsplat_tpu_torch.profile) as tests/test_profile.py holds the JAX ones,
and the scene loaders of gsplat_tpu_torch.utils.data against the JAX
loader and chip_smoke.py's scene.

Capture, replay, overrides and gradient replay on the CPU; a capture of a
port rasterization call replays to the same image; the expected-kernel
check on a trace; `run_workload` for each preset on a tiny npz the test
writes (no GSPLAT_TPU_TEST_DATA is set).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsplat_tpu.utils.data import load_test_data as j_load_test_data  # noqa: E402
from gsplat_tpu_torch import rasterization  # noqa: E402
from gsplat_tpu_torch.profile import (  # noqa: E402
    ProfileWorkload,
    capture_inputs,
    compiled_hlo_contains,
    load_inputs,
    run_workload,
)
from gsplat_tpu_torch.utils.data import (  # noqa: E402
    load_test_data,
    orbit_cameras,
    synthetic_test_data,
)


def test_capture_and_replay(tmp_path, monkeypatch):
    monkeypatch.setenv("CAPT", str(tmp_path))

    @capture_inputs("CAPT")
    def op(x, y, scale=2.0):
        return x * y * scale

    a = torch.arange(6.0).reshape(2, 3)
    b = torch.ones((2, 3))
    op(a, b, scale=3.0)
    op(b, b, scale=5.0)  # the first call's inputs only

    args, kwargs = load_inputs(str(tmp_path / "op.capture"), device="cpu")
    assert isinstance(args[0], torch.Tensor) and torch.equal(args[0], a)
    assert kwargs["scale"] == 3.0

    wl = ProfileWorkload(fn=lambda x, y, scale=2.0: x * y * scale,
                         capture_path=str(tmp_path / "op.capture"), warmup=1, repeats=2,
                         device="cpu")
    stats = wl.run()
    assert stats["time_s"] > 0 and stats["fps"] > 0

    wl2 = ProfileWorkload(fn=lambda x, y, scale=2.0: x * y * scale,
                          capture_path=str(tmp_path / "op.capture"),
                          overrides={"scale": 10.0}, warmup=1, repeats=1, device="cpu")
    _, kwargs2 = wl2.load()
    assert kwargs2["scale"] == 10.0

    stats_g = wl.run(grad_argnums=(0,))  # gradient replay
    assert stats_g["time_s"] > 0


def test_a_captured_rasterization_replays_to_the_same_image(tmp_path):
    """Tensors, numpy arrays, ints, floats, strings and None in args and
    kwargs survive the capture; the replayed call renders the same image,
    and its gradient replay runs."""
    means, quats, scales, opac, colors, viewmats, Ks, W, H = synthetic_test_data(
        n_cell=200, n_views=1, width=64, height=48)
    t = lambda x: torch.from_numpy(x)
    args = (t(means), t(quats), t(scales), t(opac), t(colors), t(viewmats), Ks, W, H)
    kwargs = dict(render_mode="RGB+ED", near_plane=0.01, backgrounds=None,
                  isect_capacity=1 << 14)
    capture = capture_inputs("UNSET_CAPTURE_DIR", path=str(tmp_path))(rasterization)
    want, _, _ = capture(*args[:6], t(Ks), W, H, **kwargs)
    from gsplat_tpu_torch.profile import save_inputs

    save_inputs(str(tmp_path / "r.capture"), args, kwargs)
    got_args, got_kwargs = load_inputs(str(tmp_path / "r.capture"), device="cpu")
    assert got_kwargs == kwargs and got_args[7:] == (W, H)
    assert all(isinstance(x, torch.Tensor) for x in got_args[:7])
    got, _, _ = rasterization(*got_args, **got_kwargs)
    assert torch.equal(got, want) and float(want[..., :3].max()) > 0
    assert (tmp_path / "rasterization.capture.npz").exists()
    stats = ProfileWorkload(rasterization, str(tmp_path / "r.capture"), warmup=0, repeats=1,
                            device="cpu").run(grad_argnums=(0, 4))
    assert stats["time_s"] > 0


def test_expected_kernel_check_reads_the_trace():
    x = torch.randn(64, 64)
    assert compiled_hlo_contains(lambda a: (a @ a).exp(), ["aten::mm", "aten::exp"], x)
    assert not compiled_hlo_contains(lambda a: a + 1, ["aten::mm"], x)


def test_load_test_data_matches_the_jax_loader(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "garden_like.npz"
    np.savez(path, means3d=rng.uniform(-3, 3, (500, 3)).astype(np.float32),
             colors=rng.integers(0, 256, (500, 3)).astype(np.uint8),
             viewmats=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
             Ks=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)), width=64, height=48)
    for grid in (1, 3):
        got = load_test_data(str(path), scene_grid=grid, seed=7)
        want = j_load_test_data(str(path), scene_grid=grid, seed=7)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert "GSPLAT_TPU_TEST_DATA" not in os.environ


def test_synthetic_test_data_is_the_chip_smoke_scene():
    import chip_smoke

    raw = chip_smoke.make_splats(300, 3, 0)
    means, quats, scales, opac, colors, viewmats, Ks, W, H = synthetic_test_data(
        scene_grid=3, seed=0, n_cell=300)
    assert (W, H) == (3840, 2160) and len(means) == 9 * 300
    np.testing.assert_array_equal(means, raw["means"])
    np.testing.assert_array_equal(quats, raw["quats"])
    np.testing.assert_allclose(np.log(scales), raw["scales"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.log(opac / (1 - opac)), raw["opacities"], rtol=0, atol=1e-5)
    np.testing.assert_allclose((colors - 0.5) / chip_smoke.SH_C0, raw["sh0"][:, 0], atol=1e-5)
    vm, K = chip_smoke.look_at_cameras(raw["means"], 4, W, H)
    np.testing.assert_array_equal(viewmats, vm)
    np.testing.assert_array_equal(Ks, np.tile(K, (4, 1, 1)))
    np.testing.assert_array_equal(orbit_cameras(means, 4, W, H)[1], K)


@pytest.mark.parametrize("name", ["3dgs", "2dgs", "3dgut"])
def test_run_workload_presets(tmp_path, name):
    means, _, _, _, colors, viewmats, Ks, W, H = synthetic_test_data(
        n_cell=200, n_views=1, width=96, height=64)
    path = tmp_path / "tiny.npz"
    np.savez(path, means3d=means, colors=np.round(colors * 255).astype(np.uint8),
             viewmats=viewmats, Ks=Ks, width=W, height=H)
    out = run_workload(name, scene_grid=1, res_factor=2, loss="l1+ssim",
                       isect_capacity=1 << 14, repeats=1, data_path=str(path), device="cpu")
    assert set(out) == {"fwd_ms", "step_ms"} and all(v > 0 for v in out.values())
