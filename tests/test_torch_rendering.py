"""Port parity: rasterization() and the serving path vs the JAX package."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.rendering import rasterization as jrast
from gsplat_tpu.scene import GaussianInferenceScene as JScene
from gsplat_tpu.scene import GaussianScene as JGaussianScene
from gsplat_tpu.scene import render_scene as jrender_scene
from gsplat_tpu_torch import rasterization as trast
from gsplat_tpu_torch.scene import (
    GaussianInferenceScene,
    Stage,
    load_checkpoint,
    render_scene,
)

W, H = 48, 40


def _band_close(a, b, name, strict=3e-5, frac=0.05, hard=2e-4):
    """The JAX suite's band assert (tests/test_rasterize_pallas.py:67-81):
    the Pallas composite carries ~1e-4-class noise against a sequential
    product; most pixels sit within `strict`, all within `hard`."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    bad = float((diff > strict).mean())
    assert bad < frac, (name, bad)
    assert float(diff.max()) < hard, (name, float(diff.max()))


def _look_at(eye, target=(0.0, 0.0, 0.0)):
    """World-to-camera matrix of a camera at `eye` looking at `target`."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def _scene(N=120, seed=0, sh_degree=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, (N,)).astype(np.float32)
    coeffs = (rng.standard_normal((N, (sh_degree + 1) ** 2, 3)) * 0.3).astype(np.float32)
    viewmats = np.stack([_look_at(np.array([3.0 * math.cos(a), 3.0 * math.sin(a), -1.0]))
                         for a in (0.3, 2.0)])
    f = 0.5 * W / math.tan(math.radians(30))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, opac, coeffs, viewmats, np.stack([K, K])


def _render(fn, conv, means, quats, scales, opac, colors, viewmats, Ks, **kw):
    return fn(*(conv(x) for x in (means, quats, scales, opac, colors, viewmats, Ks)), W, H,
              isect_capacity=8192, **kw)


@pytest.mark.parametrize("render_mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
def test_rasterization_render_modes_match_jax(render_mode):
    s = _scene()
    bg = np.array([[0.1, 0.2, 0.3], [0.5, 0.4, 0.3]], np.float32)
    kw = dict(sh_degree=3, render_mode=render_mode, rasterize_mode="antialiased",
              near_plane=0.01, far_plane=100.0)
    if "RGB" in render_mode:
        kw["backgrounds"] = bg
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jc, ja, jm = _render(jrast, jnp.asarray, *s, **jkw)
    tc, ta, tmeta = _render(trast, torch.from_numpy, *s, **tkw)
    assert tc.shape == jc.shape and ta.shape == ja.shape
    assert int(tmeta["n_isects"]) == int(jm["n_isects"]) > 0
    assert not bool(tmeta["isect_overflow"])
    np.testing.assert_array_equal(tmeta["radii"].numpy(), np.asarray(jm["radii"]))
    # the depth channel is in scene units (~3): scale the band by the depth
    scale = 1.0 if render_mode == "RGB" else 4.0
    _band_close(tc.numpy() / scale, np.asarray(jc) / scale, f"colors {render_mode}")
    _band_close(ta.numpy(), ja, f"alphas {render_mode}")


def test_rasterization_batch_dim_matches_jax():
    """Batched means [B, N, 3] with viewmats [B, C, 4, 4], post-activation
    colors [B, N, 3] and an extra signal channel."""
    means, quats, scales, opac, coeffs, viewmats, Ks = _scene(seed=1)
    rng = np.random.default_rng(9)
    B = 2
    mb = np.stack([means, means[::-1] * 0.8])
    qb, sb, ob = (np.stack([x, x]) for x in (quats, scales, opac))
    colors = rng.random((B, len(means), 3)).astype(np.float32)
    extra = rng.random((B, len(means), 2)).astype(np.float32)
    vb, Kb = np.stack([viewmats, viewmats[::-1]]), np.stack([Ks, Ks])
    jc, ja, jm = _render(jrast, jnp.asarray, mb, qb, sb, ob, colors, vb, Kb,
                         extra_signals=jnp.asarray(extra))
    tc, ta, tmeta = _render(trast, torch.from_numpy, mb, qb, sb, ob, colors, vb, Kb,
                            extra_signals=torch.from_numpy(extra))
    assert tc.shape == jc.shape == (B, 2, H, W, 3)
    _band_close(tc.numpy(), jc, "colors")
    _band_close(ta.numpy(), ja, "alphas")
    _band_close(tmeta["render_extra_signals"].numpy(), jm["render_extra_signals"], "extras")


def _write_checkpoint(path, N=150, capacity=180, seed=4):
    """A trainer-layout checkpoint: p_* raw parameters plus the alive mask
    over a capacity-padded parameter set (examples/simple_trainer.py)."""
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.uniform(-1, 1, (capacity, 3)),
        "quats": rng.standard_normal((capacity, 4)),
        "scales": np.log(rng.uniform(0.02, 0.12, (capacity, 3))),
        "opacities": rng.normal(0.0, 1.5, (capacity,)),
        "sh0": rng.standard_normal((capacity, 1, 3)) * 0.5,
        "shN": rng.standard_normal((capacity, 15, 3)) * 0.1,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = np.zeros(capacity, bool)
    alive[rng.permutation(capacity)[:N]] = True
    flat = {f"p_{k}": v for k, v in p.items()}
    flat.update({f"mu_{k}": np.zeros_like(v) for k, v in p.items()})  # optimizer state
    np.savez(path, alive=alive, step=np.int32(100), **flat)
    return p, alive


def test_checkpoint_render_scene_matches_jax(tmp_path):
    path = str(tmp_path / "ckpt_99.npz")
    p, alive = _write_checkpoint(path)
    _, _, _, _, _, viewmats, Ks = _scene()

    gscene = load_checkpoint(path, device="cpu")
    assert gscene.num_gaussians == int(alive.sum())
    inf_scene = GaussianInferenceScene.from_gaussian_scene(gscene, id="ckpt")
    assert inf_scene.get("quats").dtype == torch.bfloat16
    stage = Stage()
    stage.add_scene(gscene, lambda splats, alive=None, **kw: render_scene(inf_scene, **kw))

    jscene = JScene.from_gaussian_scene(
        JGaussianScene("ckpt", {k: jnp.asarray(v[alive]) for k, v in p.items()}), id="ckpt"
    )
    for vm, K in zip(viewmats, Ks):
        bg = np.array([[0.2, 0.3, 0.4]], np.float32)
        tc, ta, tmeta = stage.render(gscene.id, viewmat=vm, K=K, width=W, height=H,
                                     backgrounds=torch.from_numpy(bg), fast=False,
                                     isect_capacity=8192)
        jc, ja, jmeta = jrender_scene(jscene, viewmat=jnp.asarray(vm), K=jnp.asarray(K),
                                      width=W, height=H, backgrounds=jnp.asarray(bg),
                                      fast=False, isect_capacity=8192)
        assert tmeta["render_path"] == "inference"
        assert int(tmeta["n_isects"]) == int(jmeta["n_isects"]) > 0
        _band_close(tc.numpy(), jc, "colors")
        _band_close(ta.numpy(), ja, "alphas")
