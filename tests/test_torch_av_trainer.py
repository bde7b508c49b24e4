"""Port parity: the AV trainer (cameras and a spinning lidar) against the JAX
runner of examples/av_trainer.py, and the lidar losses alone.

Both runners start from the same state on synthetic_scene, perturbed by the
same normal draw (the JAX runner's own, handed to the port).  Each of 3
steps starts from the JAX runner's parameters and Adam moments, carried
across, and the port's loss and gradients are held against the JAX step's
(the loss, the camera renders and the lidar render, as AVRunner.train
writes it), the targets being the JAX runner's: losses within 1e-4
relative, gradients within 2e-3 of each parameter's largest entry, the
band of the trainer tests (test_torch_trainer_2dgs.py), and no smaller
than 1e-3 of the largest gradient of any parameter (the gaussians start
isotropic, so the quats' first gradient is rounding noise).  The JAX
step's lidar composite runs through gsplat_tpu's eval3d oracle in place of
its Pallas op, which resumes saturated pixels in later 128-slot chunks
(ROADMAP Queue 3) where the port, as the oracle, stops them.  Carrying the state keeps Adam's first
steps, which take the sign of gradients near zero, from amplifying
rounding across steps.  The port's selective-Adam step is held to JAX's
selective_adam_update on the port's gradients with the JAX step's
visibility (1e-6 of the largest entry; hidden rows untouched), and to the
JAX step's parameters, 2e-3 of the largest entry, where JAX's gradient lies
outside the gradient band.  The port's own targets agree with the JAX
runner's: images within 2e-4, lidar hit distances within 5e-5 of the
largest.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from gsplat_tpu import losses as jloss
from gsplat_tpu import rendering as j_rendering
from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.rasterize_eval3d_ref import rasterize_to_pixels_eval3d_ref
from gsplat_tpu.optimizers.adam import selective_adam_update as j_adam
from gsplat_tpu_torch import losses as tloss
from gsplat_tpu_torch.av_trainer import AVRunner, Config, synthetic_scene
from gsplat_tpu_torch.optimizers.adam import AdamState

KEYS = ("means", "scales", "quats", "opacities", "colors")
SIZE = dict(n_cams=2, W=64, H=48)


def _cfg(config_cls, **kw):
    return config_cls(max_steps=3, cap_max=768, isect_capacity=1 << 14, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _oracle_eval3d(means, quats, scales, colors, opacities, rays, width, height, radii, depths,
                   means2d, isect_capacity, backgrounds=None, tile_size=16,
                   use_hit_distance=False, return_normals=False):
    """gsplat_tpu's eval3d oracle behind the signature of its Pallas op: the
    composite whose stop rule the port follows."""
    I = colors.shape[0]
    tw, th = -(-width // tile_size), -(-height // tile_size)
    isect = isect_tiles(means2d, radii, depths, tile_size, tw, th, capacity=isect_capacity)
    offsets = isect_offset_encode(isect.tile_keys, I, tw, th)
    c, a, n = rasterize_to_pixels_eval3d_ref(
        means, quats, scales, colors, opacities, rays, width, height, tile_size, offsets,
        isect.flatten_ids, isect.n_isects, max_range=1024, backgrounds=backgrounds,
        use_hit_distance=use_hit_distance, return_normals=return_normals)
    return c, a, n, dict(n_isects=isect.n_isects, isect_overflow=isect.n_isects > isect_capacity,
                         tiles_per_gauss=jnp.zeros(radii.shape[:2], jnp.int32))


def test_three_steps_match_the_jax_runner(tmp_path, monkeypatch):
    import av_trainer as jav

    # the JAX step's lidar composite through the oracle: the Pallas kernel
    # resumes saturated pixels in later 128-slot chunks (ROADMAP Queue 3)
    monkeypatch.setattr(j_rendering, "rasterize_to_pixels_eval3d", _oracle_eval3d)
    jr = jav.AVRunner(_cfg(jav.Config, result_dir=str(tmp_path)), jav.synthetic_scene(**SIZE))
    tr = AVRunner(_cfg(Config), synthetic_scene(**SIZE, device="cpu"), device="cpu")
    cfg = jr.cfg
    for k in KEYS:
        np.testing.assert_array_equal(tr.params[k].numpy(), np.asarray(jr.params[k]), err_msg=k)
    k1, _ = jax.random.split(jax.random.PRNGKey(cfg.seed))
    noise = jax.random.normal(k1, jr.params["means"].shape)

    gt_imgs, gt_dist, gt_valid = (jnp.asarray(x) for x in jr.make_targets())
    inputs = tr.prepare(noise=_t(noise))
    np.testing.assert_allclose(inputs["gt_imgs"].numpy(), np.asarray(gt_imgs), rtol=0, atol=2e-4)
    np.testing.assert_allclose(inputs["gt_dist"].numpy(), np.asarray(gt_dist), rtol=0,
                               atol=5e-5 * float(np.abs(np.asarray(gt_dist)).max()))
    np.testing.assert_array_equal(inputs["gt_valid"].numpy(), np.asarray(gt_valid))
    assert int(gt_valid.sum()) > 0
    inputs.update(gt_imgs=_t(gt_imgs), gt_dist=_t(gt_dist), gt_valid=_t(gt_valid))
    np.testing.assert_array_equal(tr.params["means"].numpy(),
                                  np.asarray(jr.params["means"] + 0.05 * noise))
    jr.params["means"] = jr.params["means"] + 0.05 * noise

    cams, Ks = jnp.asarray(jr.scene["viewmats"]), jnp.asarray(jr.scene["Ks"])
    lvm = jnp.asarray(jr.scene["lidar_viewmats"])

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):  # AVRunner.train's loss (examples/av_trainer.py:276-295)
            colors, _, meta = jr.render_cams(p, jr.alive, cams, Ks)
            colors = jnp.clip(colors, 0.0, 1.0)
            loss = jloss.l1_loss(colors, gt_imgs) * (1 - cfg.ssim_lambda)
            loss += jloss.ssim_loss(colors, gt_imgs) * cfg.ssim_lambda
            li, la, _ = jr.render_lidar(p, jr.alive, lvm)
            loss += cfg.lidar_distance_lambda * jloss.lidar_distance_loss(li[..., -1:], gt_dist,
                                                                          gt_valid)
            loss += cfg.lidar_background_lambda * jloss.lidar_background_loss(la, ~gt_valid)
            return loss, meta["radii"]

        (loss, radii), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        visibility = (radii > 0).all(-1).any(0) & jr.alive
        params2, opt2 = j_adam(params, g, opt_state, jr.lrs, visibility=visibility)
        return params2, opt2, loss, g, visibility

    for s in range(3):
        tr.params = {k: _t(jr.params[k]) for k in KEYS}
        tr.opt_state = AdamState(mu={k: _t(jr.opt_state.mu[k]) for k in KEYS},
                                 nu={k: _t(jr.opt_state.nu[k]) for k in KEYS},
                                 count=_t(jr.opt_state.count))
        leaves = {k: v.clone().requires_grad_() for k, v in tr.params.items()}
        loss, _, lmeta = tr.loss_fn(leaves, tr.alive, **inputs)
        loss.backward()
        loss = loss.detach()
        before, opt_before = jr.params, jr.opt_state
        jr.params, jr.opt_state, jl, jg, jvis = step(jr.params, jr.opt_state)
        assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl)), (s, float(loss), float(jl))
        # the gaussians start isotropic, so the quats' gradient of step 0 is
        # rounding noise: each gradient's scale is at least 1e-3 of the
        # largest gradient of any parameter
        floor = 1e-3 * max(float(np.abs(np.asarray(jg[k])).max()) for k in KEYS)
        band = {k: 2e-3 * max(float(np.abs(np.asarray(jg[k])).max()), floor) for k in KEYS}
        for k in KEYS:
            np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg[k]), rtol=0,
                                       atol=band[k], err_msg=f"step {s}: {k}")
        assert int(lmeta["n_isects"]) > 0 and not bool(lmeta["isect_overflow"])
        # the port's own step from the same state: the same loss, and the
        # update of JAX's selective Adam with the JAX step's visibility
        t_loss, _ = tr.train_step(inputs)
        assert abs(float(t_loss) - float(loss)) <= 1e-6 * float(loss)
        jvis = np.asarray(jvis)
        assert 0 < int(jvis.sum()) < jvis.size  # the dead capacity rows are not visible
        want, want_opt = j_adam(before, {k: jnp.asarray(leaves[k].grad.numpy()) for k in KEYS},
                                opt_before, jr.lrs, visibility=jnp.asarray(jvis))
        for k in KEYS:
            got, p0, p2 = tr.params[k].numpy(), np.asarray(before[k]), np.asarray(jr.params[k])
            np.testing.assert_array_equal(got[~jvis], p0[~jvis], err_msg=f"step {s}: {k} hidden")
            for t_m, j_m in ((tr.opt_state.mu, want_opt.mu), (tr.opt_state.nu, want_opt.nu),
                             (tr.params, want)):
                w = np.asarray(j_m[k])
                np.testing.assert_allclose(t_m[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"step {s}: {k} update")
            # JAX's own step, where its gradient lies outside the band above:
            # Adam's first steps follow a gradient's sign, which the band
            # leaves open only for smaller gradients
            sure = np.abs(np.asarray(jg[k])) > band[k]
            np.testing.assert_allclose(got[sure], p2[sure], rtol=0, atol=2e-3 * np.abs(p2).max(),
                                       err_msg=f"step {s}: {k} against the JAX step")


def test_train_runs_and_the_loss_falls():
    """train() end to end on the CPU: 3 steps from the generator's own draw."""
    run = AVRunner(_cfg(Config), synthetic_scene(**SIZE, device="cpu"), device="cpu")
    losses = run.train(log=lambda m: None)
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["distance", "intensity", "raydrop", "background"])
@pytest.mark.parametrize("masked", [False, True])
def test_lidar_losses(name, masked):
    rng = np.random.default_rng(1)
    pred = rng.uniform(0.0, 1.0, (2, 24, 32, 1)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (2, 24, 32, 1)).astype(np.float32)
    mask = rng.random((2, 24, 32, 1)) > 0.3
    bg = rng.random((2, 24, 32, 1)) > 0.6
    # a masked loss needs an elementwise one (l1, mse); the others reduce to
    # a scalar, which takes no mask in either package
    kws = [dict(loss_fn="l1"), dict(loss_fn="mse")] if masked else [dict(), dict(loss_fn="huber")]
    if name == "background":
        args = (pred, bg, mask if masked else None)
        kws += [] if masked else [dict(loss_fn="bce_clipped")]
    elif name == "raydrop":
        args = (pred * 6 - 3, gt > 0.5, mask if masked else None)
        kws += [] if masked else [dict(loss_fn="smooth_l1")]
    else:
        args = (pred * 10, gt * 10, mask if masked else None)
    jf = getattr(jloss, f"lidar_{name}_loss")
    tf = getattr(tloss, f"lidar_{name}_loss")
    for kw in kws:
        want = float(jf(*(None if a is None else jnp.asarray(a) for a in args), **kw))
        got = float(tf(*(None if a is None else _t(a) for a in args), **kw))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, kw, got, want)
    with pytest.raises(ValueError, match="unknown loss_fn"):
        tf(*(None if a is None else _t(a) for a in args), loss_fn="nope")
