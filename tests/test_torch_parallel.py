"""Port parity: rasterization_sharded at two gloo ranks against the JAX
function on a 2-device mesh.

The scene of tests/test_parallel.py (32x16, N = 96 gaussians, C = 8
cameras) is written once; two processes, the ranks of a gloo world
(`cli(..., device="cpu")`), each render their own 4 cameras from their 48
gaussians with the dense exchange and the packed one, and take the
gradients of the global mean squared error (each rank's share of it) in
every input and in `means2d_offset`.  The JAX function renders the same
global arrays on jax.devices()[:2].  The JAX suite's bands: images within
3e-5 (3e-4 with the expected-depth channel), gradients within 5e-4 of each
tensor's largest entry; a packed capacity that clamps raises the overflow
flag as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gsplat_tpu.parallel import rasterization_sharded as jax_sharded
from test_torch_distributed import run_ranks

W, H = 32, 16
N, C, WORLD = 96, 8, 2
CLAMP_CAP = 150  # receive rows per rank: fewer than the visible rows, so the exchange clamps
PARAMS = ("means", "quats", "scales", "opacities", "colors")


def _scene():
    rng = np.random.default_rng(11)
    means = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2, 8, N)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.4 + 0.05).astype(np.float32)
    opacities = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    sh = (rng.standard_normal((N, 9, 3)) * 0.3).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, :3, 3] = rng.uniform(-0.5, 0.5, (C, 3)).astype(np.float32)
    Ks = np.tile(np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32),
                 (C, 1, 1))
    tgt = np.random.default_rng(4).random((C, H, W, 3)).astype(np.float32)
    return dict(means=means, quats=quats, scales=scales, opacities=opacities, colors=colors,
                sh=sh, viewmats=viewmats, Ks=Ks, tgt=tgt)


RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO_ROOT"])
from gsplat_tpu_torch import distributed as td
from gsplat_tpu_torch.parallel import rasterization_sharded

W, H = 32, 16
PARAMS = ("means", "quats", "scales", "opacities", "colors")

def main(local_rank, r, world, args):
    torch.set_num_threads(2)
    s = dict(np.load(os.path.join(os.environ["OUT_DIR"], "scene.npz")))
    n_l, c_l = len(s["means"]) // world, len(s["viewmats"]) // world
    mine = lambda k, n: torch.from_numpy(s[k][r * n:(r + 1) * n])
    g = {k: mine(k, n_l) for k in PARAMS + ("sh",)}
    cams = dict(viewmats=mine("viewmats", c_l), Ks=mine("Ks", c_l))
    mesh = td.make_gs_mesh(device="cpu")
    out = {}
    with torch.no_grad():
        for name, kw in (("dense", {}), ("packed", dict(packed=True, packed_capacity=4096)),
                         ("clamped", dict(packed=True, packed_capacity=%(clamp)d))):
            c, a, meta = rasterization_sharded(*(g[k] for k in PARAMS), **cams, width=W,
                                               height=H, mesh=mesh, **kw)
            out.update({f"{name}_colors": c.numpy(), f"{name}_alphas": a.numpy(),
                        f"{name}_overflow": np.array(bool(meta["isect_overflow"])),
                        f"{name}_n_isects": np.array(int(meta["n_isects"]))})
        c, _, _ = rasterization_sharded(g["means"], g["quats"], g["scales"], g["opacities"],
                                        g["sh"], **cams, width=W, height=H, mesh=mesh,
                                        sh_degree=2, render_mode="RGB+ED")
        out["sh_ed_colors"] = c.numpy()
    tgt = mine("tgt", c_l)
    for name, kw in (("dense", {}), ("packed", dict(packed=True, packed_capacity=4096))):
        leaves = {k: g[k].clone().requires_grad_() for k in PARAMS}
        off = torch.zeros((len(s["viewmats"]), n_l, 2), requires_grad=True)
        c, _, _ = rasterization_sharded(*(leaves[k] for k in PARAMS), **cams, width=W,
                                        height=H, mesh=mesh, means2d_offset=off, **kw)
        # this rank's share of the global mean
        loss = ((c - tgt) ** 2).sum() / float(np.prod(s["tgt"].shape))
        loss.backward()
        out.update({f"{name}_grad_{k}": leaves[k].grad.numpy() for k in PARAMS})
        out[f"{name}_grad_offset"] = off.grad.numpy()
    np.savez(os.path.join(os.environ["OUT_DIR"], f"rank{r}.npz"), **out)

td.cli(main, device="cpu")
""" % dict(clamp=CLAMP_CAP)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("parallel_ranks")
    np.savez(out_dir / "scene.npz", **scene)
    return run_ranks(RANK_SCRIPT, out_dir)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("gs",))


def _port(ranks, key):
    """The ranks' camera blocks, stacked in rank order."""
    return np.concatenate([o[key] for o in ranks])


def _jax(scene, mesh, colors="colors", **kw):
    s = {k: jnp.asarray(v) for k, v in scene.items()}
    return jax_sharded(s["means"], s["quats"], s["scales"], s["opacities"], s[colors],
                       s["viewmats"], s["Ks"], W, H, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def jax_runs(scene, mesh):
    """The JAX function's renders and the gradients of the global mean
    squared error in every input and in means2d_offset, dense and packed
    (one program each: the renders ride along as the loss's aux)."""
    s = {k: jnp.asarray(v) for k, v in scene.items()}
    runs = {}
    for mode, kw in (("dense", {}), ("packed", dict(packed=True, packed_capacity=4096))):
        def loss(means, quats, scales, opacities, colors, off):
            c, a, meta = jax_sharded(means, quats, scales, opacities, colors, s["viewmats"],
                                     s["Ks"], W, H, mesh=mesh, means2d_offset=off, **kw)
            return jnp.mean((c - s["tgt"]) ** 2), (c, a, meta)

        args = tuple(s[k] for k in PARAMS) + (jnp.zeros((C, N, 2), jnp.float32),)
        grads, (c, a, meta) = jax.grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
        runs[mode] = dict(colors=c, alphas=a, meta=meta, grads=grads)
    return runs


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_exchange_matches_jax(mode, ranks, jax_runs):
    want = jax_runs[mode]
    np.testing.assert_allclose(_port(ranks, f"{mode}_colors"), np.asarray(want["colors"]),
                               atol=3e-5, rtol=0)
    np.testing.assert_allclose(_port(ranks, f"{mode}_alphas"), np.asarray(want["alphas"]),
                               atol=3e-5, rtol=0)
    np.testing.assert_array_equal([o[f"{mode}_n_isects"] for o in ranks],
                                  np.asarray(want["meta"]["n_isects"]))
    assert not any(bool(o[f"{mode}_overflow"]) for o in ranks)
    assert not np.asarray(want["meta"]["isect_overflow"]).any()


def test_sh_with_expected_depth_matches_jax(ranks, scene, mesh):
    c, _, _ = _jax(scene, mesh, colors="sh", sh_degree=2, render_mode="RGB+ED")
    np.testing.assert_allclose(_port(ranks, "sh_ed_colors"), np.asarray(c), atol=3e-4, rtol=0)


def test_clamped_packed_exchange_flags_overflow_as_jax(ranks, scene, mesh):
    c, a, meta = _jax(scene, mesh, packed=True, packed_capacity=CLAMP_CAP)
    np.testing.assert_array_equal([bool(o["clamped_overflow"]) for o in ranks],
                                  np.asarray(meta["isect_overflow"]))
    assert np.asarray(meta["isect_overflow"]).any()
    np.testing.assert_array_equal([o["clamped_n_isects"] for o in ranks],
                                  np.asarray(meta["n_isects"]))
    np.testing.assert_allclose(_port(ranks, "clamped_colors"), np.asarray(c), atol=3e-5, rtol=0)
    np.testing.assert_allclose(_port(ranks, "clamped_alphas"), np.asarray(a), atol=3e-5, rtol=0)


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_gradients_of_every_input_and_the_offset_match_jax(mode, ranks, jax_runs):
    for name, want in zip(PARAMS + ("offset",), jax_runs[mode]["grads"]):
        want = np.asarray(want)
        if name == "offset":  # [C, n_l, 2] on each rank: the gaussian axis is sharded
            got = np.concatenate([o[f"{mode}_grad_offset"] for o in ranks], axis=1)
        else:
            got = _port(ranks, f"{mode}_grad_{name}")
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=0, err_msg=name)
