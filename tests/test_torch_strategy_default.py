"""Port parity: the default strategy and its topology ops against
gsplat_tpu/strategy, on injected random samples.

`split` draws jax.random.normal(key, (2, cap, 3)) in the JAX package; the
test hands the same draws to the port.  Tolerances: masks and alive sets
exact; parameters rtol 1e-5 (exp, log, logit and the 3x3 product round
differently in the two libraries); accumulated gradient norms rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.strategy import ops as jops
from gsplat_tpu.strategy.default import DefaultStrategy as JDefault
from gsplat_tpu_torch.strategy import DefaultStrategy
from gsplat_tpu_torch.strategy import ops as tops

CAP = 64
KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")


def _model(seed, n_alive=40):
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.standard_normal((CAP, 3)),
        "quats": rng.standard_normal((CAP, 4)),
        "scales": np.log(rng.uniform(0.002, 0.3, (CAP, 3))),
        "opacities": rng.normal(-1.0, 2.5, (CAP,)),
        "sh0": rng.standard_normal((CAP, 1, 3)),
        "shN": rng.standard_normal((CAP, 3, 3)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    mu = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    nu = {k: rng.random(v.shape).astype(np.float32) for k, v in p.items()}
    alive = np.arange(CAP) < n_alive
    mask = alive & (rng.random(CAP) < 0.3)
    return p, mu, nu, alive, mask


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _close(t_tree, j_tree, what):
    for k in KEYS:
        np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")


def test_duplicate_matches_jax():
    p, mu, nu, alive, mask = _model(0)
    jp, (jmu, jnu), jalive = jops.duplicate(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive),
                                            jnp.asarray(mask))
    tp, (tmu, tnu), talive = tops.duplicate(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                            torch.from_numpy(mask))
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert int(talive.sum()) == 40 + mask.sum()
    for got, want, what in ((tp, jp, "params"), (tmu, jmu, "mu"), (tnu, jnu, "nu")):
        for k in KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), f"{what} {k}")


@pytest.mark.parametrize("axes,revised", [((0, 1, 2), False), ((0, 1), False), ((0, 1), True)])
def test_split_matches_jax(axes, revised):
    p, mu, nu, alive, mask = _model(1, n_alive=56)  # fewer free slots than the mask
    assert mask.sum() > CAP - 56
    key = jax.random.PRNGKey(4)
    jp, (jmu, jnu), jalive = jops.split(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive),
                                        jnp.asarray(mask), key, revised_opacity=revised,
                                        sample_axes=axes)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, CAP, 3), jnp.float32)))
    tp, (tmu, tnu), talive = tops.split(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                        torch.from_numpy(mask), revised_opacity=revised,
                                        sample_axes=axes, noise=noise)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert int(talive.sum()) == CAP  # the free slots ran out
    _close(tp, jp, "params")
    _close(tmu, jmu, "mu")
    _close(tnu, jnu, "nu")
    if axes == (0, 1):  # no sample moves a child along its normal axis
        R = np.asarray(jops.quat_to_rotmat(jnp.asarray(p["quats"])))
        moved = tp["means"].numpy() - p["means"]
        sel = np.nonzero(mask)[0]
        np.testing.assert_allclose(np.einsum("nj,nj->n", moved[sel], R[sel, :, 2]), 0, atol=1e-5)


def test_remove_and_reset_opa_match_jax():
    p, mu, nu, alive, mask = _model(2)
    np.testing.assert_array_equal(tops.remove(torch.from_numpy(alive), torch.from_numpy(mask)).numpy(),
                                  np.asarray(jops.remove(jnp.asarray(alive), jnp.asarray(mask))))
    jp, (jmu, jnu) = jops.reset_opa(_j(p), (_j(mu), _j(nu)), 0.01)
    tp, (tmu, tnu) = tops.reset_opa(_t(p), (_t(mu), _t(nu)), 0.01)
    _close(tp, jp, "params")
    _close(tmu, jmu, "mu")
    assert (tnu["opacities"] == 0).all() and float(tp["opacities"].max()) < -4.59


def _state(seed, strategy, jstrategy, n_cameras=2):
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((n_cameras, CAP, 2)).astype(np.float32) * 1e-5
    radii = rng.integers(0, 4, (n_cameras, CAP, 2)).astype(np.int32)
    js = jstrategy.initialize_state(CAP, scene_scale=1.7)
    ts = strategy.initialize_state(CAP, scene_scale=1.7)
    for _ in range(2):
        js = jstrategy.update_state(js, jnp.asarray(grads), jnp.asarray(radii), 64, 48, n_cameras)
        ts = strategy.update_state(ts, torch.from_numpy(grads), torch.from_numpy(radii), 64, 48,
                                   n_cameras)
    return js, ts


@pytest.mark.parametrize("stop2d", [0, 1000])
def test_update_state_matches_jax(stop2d):
    js, ts = _state(3, DefaultStrategy(refine_scale2d_stop_iter=stop2d),
                    JDefault(refine_scale2d_stop_iter=stop2d))
    assert set(ts) == set(js) and ts["scene_scale"] == js["scene_scale"] == 1.7
    for k in set(ts) - {"scene_scale"}:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-6, err_msg=k)
    assert float(ts["count"].max()) > 0 and float(ts["grad2d"].max()) > 0


@pytest.mark.parametrize("step,axes", [(600, (0, 1, 2)), (3100, (0, 1)), (3100, (0, 1, 2))])
def test_refine_matches_jax(step, axes):
    """grow (duplicate, then split), prune (by opacity, and by size after
    reset_every), and clear the statistics, as the JAX strategy does."""
    kw = dict(grow_grad2d=2e-4, scale_axes=axes, refine_scale2d_stop_iter=4000)
    js_, ts_ = JDefault(**kw), DefaultStrategy(**kw)
    p, mu, nu, alive, _ = _model(5, n_alive=30)
    p["scales"][:8] = np.log(np.float32(0.5))  # too big after reset_every
    jstate, tstate = _state(6, ts_, js_)
    key = jax.random.PRNGKey(9)
    jp, (jmu, jnu), jalive, jst = js_.refine(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive), jstate,
                                             step, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, CAP, 3), jnp.float32)))
    tp, (tmu, tnu), talive, tst = ts_.refine(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                             tstate, step, noise=noise)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    _close(tp, jp, "params")
    _close(tmu, jmu, "mu")
    grew = int(talive[30:].sum())
    assert grew > 0 and int((~talive[:30]).sum()) > 0  # both grew and pruned
    assert all(float(tst[k].abs().sum()) == 0 for k in ("grad2d", "count", "radii"))


def test_schedule_and_generator_draws():
    js_, ts_ = JDefault(refine_every=3, refine_start_iter=1, reset_every=6,
                        pause_refine_after_reset=2), \
        DefaultStrategy(refine_every=3, refine_start_iter=1, reset_every=6,
                        pause_refine_after_reset=2)
    for step in range(40):
        assert ts_.should_refine(step) == js_.should_refine(step), step
        assert ts_.should_reset_opa(step) == js_.should_reset_opa(step), step
    p, mu, nu, alive, mask = _model(7)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        outs.append(tops.split(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                               torch.from_numpy(mask), g)[0]["means"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], torch.from_numpy(p["means"]))
