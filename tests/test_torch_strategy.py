"""Port parity: the MCMC strategy ops vs gsplat_tpu/strategy, on injected
random samples.

`jax.random` and `torch.Generator` give different numbers, so each test
draws the uniform or normal samples with the key the JAX function will use
(`jax.random.uniform(key, (cap,))` in `_sample_alive`, `jax.random.normal`
in `inject_noise_to_position`; `MCMCStrategy.refine` splits its key once)
and hands them to the port as numpy.  Tolerances: index choices exact;
`compute_relocation` 1e-6; parameters after an op rtol 1e-5 (log, logit and
sigmoid differ by float32 ulps between the two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.strategy import ops as jops
from gsplat_tpu.strategy.mcmc import MCMCStrategy as JMCMC
from gsplat_tpu_torch.strategy import MCMCStrategy, Strategy
from gsplat_tpu_torch.strategy import ops as tops

CAP = 64
KEYS = ("means", "quats", "scales", "opacities", "sh0", "shN")


def _model(seed, n_alive=40, n_dead=6):
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.standard_normal((CAP, 3)),
        "quats": rng.standard_normal((CAP, 4)),
        "scales": np.log(rng.uniform(0.01, 0.3, (CAP, 3))),
        "opacities": rng.normal(0.0, 1.5, (CAP,)),
        "sh0": rng.standard_normal((CAP, 1, 3)),
        "shN": rng.standard_normal((CAP, 3, 3)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alive = np.arange(CAP) < n_alive
    dead_idx = rng.choice(n_alive, n_dead, replace=False)
    p["opacities"][dead_idx] = -7.0  # sigmoid(-7) < min_opacity
    mu = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    nu = {k: rng.random(v.shape).astype(np.float32) for k, v in p.items()}
    return p, mu, nu, alive


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _assert_trees_close(t_tree, j_tree, what):
    for k in KEYS:
        np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")


def test_binoms_and_compute_relocation_match_jax():
    np.testing.assert_array_equal(tops.make_binoms(51).numpy(), np.asarray(jops.make_binoms(51)))
    rng = np.random.default_rng(0)
    op = rng.uniform(0.001, 0.999, 500).astype(np.float32)
    sc = rng.uniform(0.01, 1.0, (500, 3)).astype(np.float32)
    ratios = rng.integers(1, 60, 500).astype(np.int32)  # past n_max = 51 too
    ratios[:5] = [1, 2, 50, 51, 52]
    j_op, j_sc = jops.compute_relocation(jnp.asarray(op), jnp.asarray(sc), jnp.asarray(ratios),
                                         jops.make_binoms(51))
    t_op, t_sc = tops.compute_relocation(torch.from_numpy(op), torch.from_numpy(sc),
                                         torch.from_numpy(ratios), tops.make_binoms(51))
    np.testing.assert_allclose(t_op.numpy(), np.asarray(j_op), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_alive_picks_the_jax_indices(seed):
    p, _, _, alive = _model(seed)
    key = jax.random.PRNGKey(seed)
    op = 1.0 / (1.0 + np.exp(-p["opacities"]))
    want = np.asarray(jops._sample_alive(key, jnp.asarray(op), jnp.asarray(alive), CAP))
    u = np.array(jax.random.uniform(key, (CAP,)))
    got = tops._sample_alive(torch.from_numpy(op), torch.from_numpy(alive), CAP,
                             u=torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert alive[got].all()
    # without injected samples: the generator's draws land on alive slots too
    g = torch.Generator().manual_seed(seed)
    own = tops._sample_alive(torch.from_numpy(op), torch.from_numpy(alive), 1000, generator=g)
    assert alive[own.numpy()].all() and len(np.unique(own.numpy())) > 10


@pytest.mark.parametrize("seed", [0, 3])
def test_relocate_matches_jax(seed):
    p, mu, nu, alive = _model(seed)
    key = jax.random.PRNGKey(seed + 10)
    dead = alive & (1.0 / (1.0 + np.exp(-p["opacities"])) <= 0.005)
    assert dead.sum() == 6
    jp, (jmu, jnu), jalive = jops.relocate(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive),
                                           jnp.asarray(dead), jops.make_binoms(51), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (CAP,))))
    tp, (tmu, tnu), talive = tops.relocate(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                           torch.from_numpy(dead), tops.make_binoms(51), u=u)
    _assert_trees_close(tp, jp, "params")
    _assert_trees_close(tmu, jmu, "mu")
    _assert_trees_close(tnu, jnu, "nu")
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    # dead slots copied a live source; their moments and the sources' are zero
    assert (tmu["means"][torch.from_numpy(dead)] == 0).all()
    assert (torch.sigmoid(tp["opacities"][torch.from_numpy(dead)]) > 0.005 - 1e-6).all()


@pytest.mark.parametrize("n_add", [5, 100])
def test_sample_add_matches_jax(n_add):
    p, mu, nu, alive = _model(4)
    key = jax.random.PRNGKey(7)
    jp, (jmu, jnu), jalive = jops.sample_add(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive),
                                             jnp.asarray(n_add, jnp.int32), jops.make_binoms(51), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (CAP,))))
    tp, (tmu, tnu), talive = tops.sample_add(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                             n_add, tops.make_binoms(51), u=u)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert int(talive.sum()) == min(40 + n_add, CAP)  # clamped by the free slots
    _assert_trees_close(tp, jp, "params")
    _assert_trees_close(tmu, jmu, "mu")
    _assert_trees_close(tnu, jnu, "nu")


def test_inject_noise_matches_jax():
    p, _, _, alive = _model(5)
    key = jax.random.PRNGKey(3)
    jp = jops.inject_noise_to_position(_j(p), jnp.asarray(alive), key, 0.8)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (CAP, 3), jnp.float32)))
    tp = tops.inject_noise_to_position(_t(p), torch.from_numpy(alive), 0.8, noise=noise)
    _assert_trees_close(tp, jp, "params")
    moved = np.abs(tp["means"].numpy() - p["means"]).sum(-1) > 0
    assert moved[:40].any() and not moved[40:].any()  # free slots stay put


@pytest.mark.parametrize("seed", [0, 1])
def test_mcmc_refine_and_noise_match_jax(seed):
    p, mu, nu, alive = _model(seed + 20)
    key = jax.random.PRNGKey(seed)
    js = JMCMC(cap_max=CAP, refine_every=3, refine_start_iter=1)
    ts = MCMCStrategy(cap_max=CAP, refine_every=3, refine_start_iter=1)
    for step in range(8):
        assert ts.should_refine(step) == js.should_refine(step)
        assert ts.should_inject_noise(step) == js.should_inject_noise(step)
    jp, (jmu, jnu), jalive = js.refine(_j(p), (_j(mu), _j(nu)), jnp.asarray(alive),
                                       js.initialize_state(), key)
    k1, k2 = jax.random.split(key)
    u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(k, (CAP,)))) for k in (k1, k2))
    tp, (tmu, tnu), talive = ts.refine(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                       ts.initialize_state(), u_relocate=u1, u_add=u2)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert int(talive.sum()) == 42  # int(1.05 * 40)
    _assert_trees_close(tp, jp, "params")
    _assert_trees_close(tmu, jmu, "mu")
    _assert_trees_close(tnu, jnu, "nu")
    jn = js.inject_noise(jp, jalive, key, 1e-3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (CAP, 3), jnp.float32)))
    tn = ts.inject_noise(tp, talive, 1e-3, noise=noise)
    _assert_trees_close(tn, jn, "after noise")


def test_refine_with_a_generator_is_reproducible_and_sane():
    p, mu, nu, alive = _model(30)
    ts = MCMCStrategy(cap_max=CAP)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        tp, (tmu, _), talive = ts.refine(_t(p), (_t(mu), _t(nu)), torch.from_numpy(alive),
                                         ts.initialize_state(), g)
        tp = ts.inject_noise(tp, talive, 1e-3, g)
        outs.append((tp, talive))
    for k in KEYS:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
    assert int(outs[0][1].sum()) == 42
    assert all(torch.isfinite(v).all() for v in outs[0][0].values())


def test_tree_helpers_and_sanity_check():
    p = _t(_model(6)[0])
    before = p["means"].clone()
    tops._tree_write(p, torch.tensor([50, 51]), torch.tensor([3, 3]))  # duplicate sources count
    assert torch.equal(p["means"][50], before[3]) and torch.equal(p["shN"][51], p["shN"][3])
    with pytest.raises(ValueError, match="duplicate destination"):
        tops._tree_write(p, torch.tensor([50, 50]), torch.tensor([1, 2]))
    tops._tree_zero_at((p, p), torch.tensor([0, 7]))
    assert (p["quats"][[0, 7]] == 0).all() and (p["quats"][1] != 0).any()
    s = Strategy()
    s.check_sanity(p, (p, p))
    with pytest.raises(ValueError, match="share keys"):
        s.check_sanity(p, {k: v for k, v in p.items() if k != "shN"})
    with pytest.raises(ValueError, match="shape"):
        s.check_sanity(p, {**p, "shN": p["shN"][:, :1]})
