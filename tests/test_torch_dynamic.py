"""Port parity: contrib/dynamic and the dynamic trainer against the JAX package.

grid_sample_2d against the JAX function and F.grid_sample; hexplane_apply
and deform_network_apply on the JAX draws carried across
(scene.convert.hexplane_from_numpy / deform_params_from_numpy); the
regularisers; DeformationTable; DynamicStrategy's state through a refine;
and the trainer's steps against the JAX runner's from the same start on the
synthetic scene.  (The EndoNeRF runner is held to the JAX one in
test_torch_datasets_extra.py, beside its reader.)  Tolerances: 1e-5 for
the sampling, the fields and the regularisers (float32 sums in another
order); the trainer as `synced_steps` says.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import gsplat_tpu.contrib.dynamic as jdyn
import gsplat_tpu_torch.contrib.dynamic as tdyn
from gsplat_tpu_torch import dynamic_trainer as tdt
from gsplat_tpu_torch.scene.convert import deform_params_from_numpy, hexplane_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import dynamic_surgical_trainer as jdt  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_grid_sample_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(8, 16, 24)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (300, 2)).astype(np.float32)  # the border too
    coords[:4] = [[1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [1.3, 0.2]]  # the last row and column
    got = tdyn.grid_sample_2d(torch.from_numpy(grid), torch.from_numpy(coords)).numpy()
    want = np.asarray(jdyn.grid_sample_2d(jnp.asarray(grid), jnp.asarray(coords)))
    ref = F.grid_sample(torch.from_numpy(grid)[None], torch.from_numpy(coords)[None, None],
                        align_corners=True, mode="bilinear",
                        padding_mode="border")[0, :, 0].T.numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def carried():
    """The JAX draws (default HexPlane: 2 scales of 32 features; a deform
    net with random heads, so that the trunk shows) and the port's copies."""
    hp = jdyn.hexplane_init(jax.random.PRNGKey(0))
    dp = jdyn.deform_network_init(jax.random.PRNGKey(2), feature_dim=hp["feat_dim"],
                                  hidden_dim=32, num_layers=2)
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    for i, head in enumerate(("pos", "quat", "opacity")):
        dp[head]["w"] = jax.random.normal(keys[2 * i], dp[head]["w"].shape) * 0.1
        dp[head]["b"] = jax.random.normal(keys[2 * i + 1], dp[head]["b"].shape) * 0.1
    hp_np = dict(hp, grids=_np(hp["grids"]), aabb=np.asarray(hp["aabb"]))
    hp_np["grids"][0][2] = hp_np["grids"][0][2] + np.random.default_rng(3).normal(
        0, 0.1, hp_np["grids"][0][2].shape).astype(np.float32)  # a rough xt plane
    hp = dict(hp, grids=jax.tree.map(jnp.asarray, hp_np["grids"]))
    return hp, dp, hexplane_from_numpy(hp_np, device="cpu"), deform_params_from_numpy(
        _np(dp), device="cpu")


def test_hexplane_and_deform_net_match_jax_on_carried_weights(carried):
    hp, dp, thp, tdp = carried
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (200, 4)).astype(np.float32)
    want = np.asarray(jdyn.hexplane_apply(hp, jnp.asarray(pts)))
    got = tdyn.hexplane_apply(thp, torch.from_numpy(pts)).numpy()
    assert got.shape == (200, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    m, q, o = (rng.normal(size=(200, d)).astype(np.float32) for d in (3, 4, 1))
    jout = jdyn.deform_network_apply(dp, *map(jnp.asarray, (m, q, o)), None, jnp.asarray(want))
    tout = tdyn.deform_network_apply(tdp, *map(torch.from_numpy, (m, q, o)), None,
                                     torch.from_numpy(want))
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_regularisers_match_jax(carried):
    hp, _, thp, _ = carried
    for name in ("plane_smoothness", "time_smoothness", "time_l1"):
        for planes in ("spatial_planes", "temporal_planes"):
            want = float(getattr(jdyn, name)(getattr(jdyn, planes)(hp)))
            got = float(getattr(tdyn, name)(getattr(tdyn, planes)(thp)))
            assert got == pytest.approx(want, rel=1e-5, abs=1e-7), (name, planes)
    want = float(jdyn.hexplane_regularization(hp, 0.5, 2.0, 3.0))
    assert float(tdyn.hexplane_regularization(thp, 0.5, 2.0, 3.0)) == pytest.approx(want,
                                                                                    rel=1e-5)
    assert float(tdyn.time_l1(tdyn.temporal_planes(thp))) > 0  # the rough plane


def test_time_l1_gradient_at_the_ones_initialisation_is_jax_s():
    """The temporal planes start at exactly 1, where |1 - p| has its kink:
    the JAX gradient is -1/n (jnp.abs's derivative at 0 is +1), which Adam
    turns into a full step, so the port's must be -1/n too (torch.abs's
    derivative at 0 is 0)."""
    planes = [np.ones((4, 5, 6), np.float32), np.full((2, 3, 3), 1.5, np.float32)]
    want = jax.grad(lambda ps: jdyn.time_l1(ps))([jnp.asarray(p) for p in planes])
    leaves = [torch.from_numpy(p).requires_grad_() for p in planes]
    tdyn.time_l1(leaves).backward()
    for g, w in zip(leaves, want):
        np.testing.assert_array_equal(g.grad.numpy(), np.asarray(w))
    assert float(leaves[0].grad[0, 0, 0]) == pytest.approx(-1.0 / 120, rel=1e-6)


def test_port_init_keeps_the_layout_and_the_identity():
    hp = tdyn.hexplane_init(torch.Generator().manual_seed(0), device="cpu")
    jhp = jdyn.hexplane_init(jax.random.PRNGKey(0))
    assert hp["feat_dim"] == jhp["feat_dim"] == 64 and hp["coo_combs"] == jhp["coo_combs"]
    for s, js in zip(hp["grids"], jhp["grids"]):
        assert [tuple(p.shape) for p in s] == [p.shape for p in js]
    assert all(bool((p == 1).all()) for p in tdyn.temporal_planes(hp))
    assert all(0.1 <= float(p.min()) and float(p.max()) <= 0.5 for p in tdyn.spatial_planes(hp))
    dp = tdyn.deform_network_init(torch.Generator().manual_seed(2), feature_dim=64,
                                  device="cpu")
    x = torch.randn(20, 3), torch.randn(20, 4), torch.randn(20, 1)
    out = tdyn.deform_network_apply(dp, *x, None, torch.randn(20, 64))
    assert all(torch.equal(a, b) for a, b in zip(out, x))
    with pytest.raises(ValueError):
        tdyn.deform_network_init(None, feature_dim=0, device="cpu")


def test_deformation_table_follows_the_jax_table():
    ops = [("set_indices", ([1, 4],)), ("duplicate", ([1, 2],)), ("split", ([1, 6], 3)),
           ("prune", (np.arange(12) % 4 != 0,)), ("set_indices", ([0], False))]
    j, t = jdyn.DeformationTable(6), tdyn.DeformationTable(6)
    for name, args in ops:
        getattr(j, name)(*args)
        getattr(t, name)(*args)
        np.testing.assert_array_equal(t.mask, j.mask)
    assert len(t) == len(j) == 9


def test_dynamic_strategy_state_follows_a_refine_as_in_jax():
    kw = dict(refine_start_iter=0, refine_stop_iter=100, refine_every=1, grow_grad2d=1e-9,
              sidecar_state_keys=("dynamic_mask",))
    cap, n = 32, 8
    rng = np.random.default_rng(4)
    params = dict(means=rng.normal(size=(cap, 3)), quats=rng.normal(size=(cap, 4)),
                  scales=np.log(rng.uniform(0.001, 0.002, (cap, 3))),
                  opacities=np.full(cap, 2.0))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = np.arange(cap) < n

    js = jdyn.DynamicStrategy(**kw)
    jstate = js.initialize_state(cap)
    jstate["dynamic_mask"] = jstate["dynamic_mask"].at[:4].set(True)
    jstate["grad2d"] = jnp.where(jnp.asarray(alive), 1.0, 0.0)
    jstate["count"] = jnp.ones(cap)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, _, jalive, jstate = js.refine(jp, (jax.tree.map(jnp.zeros_like, jp),), jnp.asarray(alive),
                                     jstate, step=10, key=jax.random.PRNGKey(0))

    ts = tdyn.DynamicStrategy(**kw)
    tstate = ts.initialize_state(cap, device="cpu")
    assert tstate["dynamic_mask"].dtype == torch.bool and not tstate["dynamic_mask"].any()
    tstate["dynamic_mask"][:4] = True
    tstate["grad2d"] = torch.from_numpy(alive.astype(np.float32))
    tstate["count"] = torch.ones(cap)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    _, _, talive, tstate = ts.refine(tp, ({k: torch.zeros_like(v) for k, v in tp.items()},),
                                     torch.from_numpy(alive), tstate, step=10)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(tstate["dynamic_mask"].numpy(),
                                  np.asarray(jstate["dynamic_mask"]))
    assert talive.sum() == 2 * n and tstate["dynamic_mask"][n:n + 4].all()


def jax_runner_start(cfg):
    """The JAX runner's own draws (examples/dynamic_surgical_trainer.py:
    run_training, :209-220), as JAX arrays and carried to the port."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    hp = jdyn.hexplane_init(k1, bounds=6.0, planes_config=tdt.HEX_CONFIG, multires=(1,))
    dp = jdyn.deform_network_init(k2, feature_dim=hp["feat_dim"], hidden_dim=48, num_layers=2)
    hp_np = dict(hp, grids=_np(hp["grids"]), aabb=np.asarray(hp["aabb"]))
    return hp, dp, hexplane_from_numpy(hp_np, device="cpu"), deform_params_from_numpy(
        _np(dp), device="cpu")


def jax_loss_and_grad(cfg, hex_static, dyn_mask, alive, Ks, masked: bool):
    """The JAX runner's render and loss (examples/dynamic_surgical_trainer.py:
    246-269, 284-302), jitted with their gradients in the splats, the grids
    and the deform network."""
    from gsplat_tpu import losses as jl
    from gsplat_tpu.rendering import rasterization

    cap = cfg.cap

    def loss_fn(p, h, d, t, viewmats, gt_img, mask_img):
        hp = dict(hex_static)
        hp.update(h)
        xyzt = jnp.concatenate([p["means"], jnp.full((cap, 1), t, jnp.float32)], axis=1)
        feats = jdyn.hexplane_apply(hp, xyzt)
        m2, q2, o2 = jdyn.deform_network_apply(d, p["means"], p["quats"],
                                               p["opacities"][:, None], None, feats)
        sel = dyn_mask[:, None]
        means = jnp.where(sel, m2, p["means"])
        quats = jnp.where(sel, q2, p["quats"])
        opac = jnp.where(dyn_mask, o2[:, 0], p["opacities"])
        op = jnp.where(alive, jax.nn.sigmoid(opac), 0.0)
        img, _, meta = rasterization(means, quats, jnp.exp(p["scales"]), op,
                                     jax.nn.sigmoid(p["colors"]), viewmats, Ks, cfg.W, cfg.H,
                                     isect_capacity=1 << 18)
        img = jnp.clip(img, 0, 1)
        if masked:
            loss = jl.masked_l1(img, gt_img, mask_img) * (1 - cfg.ssim_lambda)
            loss += (1.0 - jl.masked_ssim(img, gt_img, mask_img)) * cfg.ssim_lambda
        else:
            loss = jl.l1_loss(img, gt_img) * (1 - cfg.ssim_lambda)
            loss += jl.ssim_loss(img, gt_img) * cfg.ssim_lambda
        loss += cfg.lambda_hexplane_reg * jdyn.hexplane_regularization(hp)
        return loss, meta["radii"]

    return jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))


def synced_steps(runner, jp_start, n_steps: int, jax_gt=None, grads: bool = True):
    """Each step from the same state (the JAX loss on `jax_gt` [T, C, H, W,
    3], its own render of the targets, else on the runner's targets): the
    port's loss within 1e-4 relative and, with `grads`, its gradients in
    every splat parameter, grid and network weight within 2e-3 of the
    larger of the JAX gradient's largest entry and 1e-3 of the step's
    largest gradient (Adam's first steps follow a gradient's sign, so each
    step restarts from the JAX state); then the JAX runner's update
    (selective Adam on visibility, Adam for the grids and the network).
    Returns the port's losses."""
    from gsplat_tpu.optimizers.adam import adam_init, adam_update, selective_adam_update

    cfg = runner.cfg
    hp, dp = jp_start
    t = lambda x: torch.from_numpy(np.array(x))
    alive = jnp.asarray(runner.alive.numpy())
    f = jax_loss_and_grad(cfg, hp, jnp.asarray(runner.dyn_mask.numpy()), alive,
                          jnp.asarray(runner.Ks.numpy()), runner.loss_masks is not None)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in runner.params.items()}
    jhex, jdef = {"grids": hp["grids"]}, dp
    opts = adam_init(jparams), adam_init(jhex), adam_init(jdef)
    lrs = dict(means=cfg.lr_splats_means, scales=cfg.lr_splats, quats=cfg.lr_splats,
               opacities=cfg.lr_splats, colors=cfg.lr_splats)

    @jax.jit
    def update(jparams, jhex, jdef, gp, gh, gd, opts, vis):  # one compile, as the runner's
        jparams, o0 = selective_adam_update(jparams, gp, opts[0], lrs, visibility=vis)
        jhex, o1 = adam_update(jhex, gh, opts[1], cfg.lr_hexplane)
        jdef, o2 = adam_update(jdef, gd, opts[2], cfg.lr_deform)
        return jparams, jhex, jdef, (o0, o1, o2)

    losses = []
    for step in range(n_steps):
        ti = step % cfg.n_times
        mask = (runner.loss_masks[ti] if runner.loss_masks is not None else runner.gt[ti][..., :1])
        (jloss, radii), (gp, gh, gd) = f(jparams, jhex, jdef, float(runner.scene["times"][ti]),
                                         jnp.asarray(runner.viewmats_t[ti].numpy()),
                                         jnp.asarray(runner.gt[ti].numpy()) if jax_gt is None
                                         else jax_gt[ti], jnp.asarray(mask.numpy()))
        leaves = [{k: t(jparams[k]).requires_grad_() for k in jparams},
                  {k: t(v).requires_grad_() for k, v in tdt._flat_grids(jhex["grids"]).items()},
                  {k: t(v).requires_grad_() for k, v in tdt._flat_deform(jdef).items()}]
        loss, meta = runner.loss_fn(*leaves, ti)
        loss.backward()
        loss = loss.detach()
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss)), (step, float(loss),
                                                                             float(jloss))
        want = [_np(gp), tdt._flat_grids(_np(gh["grids"])), tdt._flat_deform(_np(gd))]
        floor = 1e-3 * max(float(np.abs(w).max()) for ws in want for w in ws.values())
        for got_d, want_d in zip(leaves if grads else (), want):
            for k, w in want_d.items():
                band = 2e-3 * max(float(np.abs(w).max()), floor)
                np.testing.assert_allclose(got_d[k].grad.numpy(), w, rtol=0, atol=band,
                                           err_msg=f"step {step}: {k}")
        vis = (radii > 0).all(-1).any(0) & alive
        np.testing.assert_array_equal((meta["radii"] > 0).all(-1).any(0).numpy(),
                                      np.asarray((radii > 0).all(-1).any(0)))
        jparams, jhex, jdef, opts = update(jparams, jhex, jdef, gp, gh, gd, opts, vis)
        losses.append(float(loss))
    return losses


def test_synthetic_steps_match_the_jax_runner():
    """The synthetic regime from the JAX runner's start: the targets (renders
    of the true displaced scenes) against the JAX rasterization of the same
    scenes, then three steps' losses held to the JAX runner's, each from the
    same state and each package on its own targets; run_training's first
    loss is the first step's.  The gradients are not compared here: on the
    static background a target equals the render to within rounding, and
    l1's gradient there takes the rounding's sign (in the JAX runner too,
    whose targets are eager renders and whose steps are jitted ones), so
    they are held to JAX on the EndoNeRF regime, where no pixel ties."""
    from gsplat_tpu.rendering import rasterization as jras

    cfg = tdt.Config(max_steps=3, cap=640, W=40, H=30, n_times=3)
    scene = tdt.synthetic_dynamic_scene(cfg)
    jscene = jdt.synthetic_dynamic_scene(jdt.Config(**{k: getattr(cfg, k) for k in (
        "max_steps", "cap", "W", "H", "n_times")}))
    for k in ("points", "rgb", "dyn_mask", "viewmats", "Ks", "times"):
        np.testing.assert_array_equal(scene[k], jscene[k], err_msg=k)
    hp, dp, thp, tdp = jax_runner_start(cfg)
    runner = tdt.DynamicRunner(cfg, scene, device="cpu", hex_params=thp, deform_params=tdp)
    render = jax.jit(jras, static_argnums=(7, 8), static_argnames=("isect_capacity",))
    p = {k: jnp.asarray(v.numpy()) for k, v in runner.params.items()}
    jax_gt = []
    for ti, t in enumerate(scene["times"]):
        means = np.zeros((cfg.cap, 3), np.float32)
        means[: len(scene["points"])] = jscene["displaced"](float(t))
        want, _, _ = render(jnp.asarray(means), p["quats"], jnp.exp(p["scales"]),
                            jnp.where(jnp.asarray(runner.alive.numpy()),
                                      jax.nn.sigmoid(p["opacities"]), 0.0),
                            jax.nn.sigmoid(p["colors"]), jnp.asarray(runner.viewmats_t[ti].numpy()),
                            jnp.asarray(runner.Ks.numpy()), cfg.W, cfg.H, isect_capacity=1 << 18)
        np.testing.assert_allclose(runner.gt[ti].numpy(), np.asarray(want), rtol=0, atol=2e-4)
        jax_gt.append(want)
    losses = synced_steps(runner, (hp, dp), 3, jax_gt, grads=False)
    again = tdt.run_training(cfg, scene, device="cpu", hex_params=thp, deform_params=tdp,
                             log=lambda m: None)
    assert again[0] == pytest.approx(losses[0], rel=1e-6) and np.isfinite(again).all()
