"""Port parity: the JAX package's parity arguments of rasterization()
(`packed`, `sparse_grad`, `channel_chunk`, `distributed`, `segmented`) and
of rasterization_2dgs() (`distloss`), by keyword and by position, and
through render_scene.

Each argument sits at the JAX package's position, renders the same image
(the band of tests/test_torch_rendering.py for rasterization, 2e-4 as in
tests/test_torch_rasterize2d.py for 2DGS) and gives the same warnings.
"""

import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.rendering import rasterization as jrast
from gsplat_tpu.rendering import rasterization_2dgs as jrast2d
from gsplat_tpu.scene import GaussianInferenceScene as JScene
from gsplat_tpu.scene import GaussianScene as JGaussianScene
from gsplat_tpu.scene import render_scene as jrender_scene
from gsplat_tpu_torch import rasterization as trast
from gsplat_tpu_torch.rendering import rasterization_2dgs as trast2d
from gsplat_tpu_torch.scene import GaussianInferenceScene, load_checkpoint, render_scene

import test_torch_projection2d as p2d
from test_torch_rendering import H, W, _band_close, _scene, _write_checkpoint

# a value other than the default for each parity argument
PARITY = {"packed": False, "sparse_grad": True, "channel_chunk": 16, "distributed": True,
          "segmented": True}
# the defaults of every positional parameter up to the last parity one
DEFAULTS = dict(near_plane=0.01, far_plane=100.0, radius_clip=0.0, eps2d=0.3, sh_degree=3,
                packed=True, tile_size=16, backgrounds=None, render_mode="RGB",
                sparse_grad=False, absgrad=False, rasterize_mode="classic", channel_chunk=32,
                distributed=False, camera_model="pinhole", segmented=False)
SCENE_KEYS = ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")


def _effect_warnings(record):
    """(category, what) of each "has no effect" warning, the text up to the
    reason, which names the backend."""
    return sorted((w.category.__name__, str(w.message).split(" has no effect")[0])
                  for w in record if "has no effect" in str(w.message))


def _call(fn, args, kwargs):
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, _effect_warnings(record)


def test_parity_arguments_sit_at_the_jax_positions():
    for jfn, tfn in ((jrast, trast), (jrast2d, trast2d)):
        jp = inspect.signature(jfn).parameters
        tp = inspect.signature(tfn).parameters
        assert list(tp) == list(jp)
        for name in list(PARITY) + ["distloss"]:
            if name in jp:
                assert tp[name].default == jp[name].default, name


@pytest.mark.parametrize("by", ["keyword", "position"])
@pytest.mark.parametrize("name", list(PARITY))
def test_rasterization_parity_argument_matches_jax(name, by):
    s = _scene()
    outs, warned = {}, {}
    for pkg, fn, conv in (("jax", jrast, jnp.asarray), ("torch", trast, torch.from_numpy)):
        args = [conv(x) for x in s] + [W, H]
        kwargs = dict(isect_capacity=8192)
        if by == "keyword":
            kwargs.update(near_plane=0.01, far_plane=100.0, sh_degree=3, **{name: PARITY[name]})
        else:
            pos = dict(DEFAULTS, **{name: PARITY[name]})
            names = list(pos)
            args += [pos[k] for k in names[: names.index(name) + 1]]
            kwargs.update({k: pos[k] for k in names[names.index(name) + 1:]})
        outs[pkg], warned[pkg] = _call(fn, args, kwargs)
    (jc, ja, jm), (tc, ta, tm) = outs["jax"], outs["torch"]
    assert int(tm["n_isects"]) == int(jm["n_isects"]) > 0
    _band_close(tc.numpy(), jc, f"colors {name} by {by}")
    _band_close(ta.numpy(), ja, f"alphas {name} by {by}")
    assert warned["torch"] == warned["jax"]
    assert bool(warned["torch"]) == (name in ("sparse_grad", "channel_chunk", "segmented"))


@pytest.mark.parametrize("by", ["keyword", "position"])
def test_rasterization_2dgs_distloss_matches_jax(by):
    s = p2d.surfel_scene()
    outs = {}
    for pkg, fn, conv in (("jax", jrast2d, jnp.asarray), ("torch", trast2d, torch.from_numpy)):
        args = [conv(s[k]) for k in SCENE_KEYS] + [p2d.W, p2d.H]
        if by == "keyword":
            kwargs = dict(render_mode="RGB+ED", distloss=True)
        else:
            # near_plane, far_plane, sh_degree, tile_size, backgrounds, render_mode, distloss
            args += [0.01, 1e10, None, 16, None, "RGB+ED", True]
            kwargs = {}
        outs[pkg], warned = _call(fn, args, kwargs)
        assert warned == []
    names = ("render", "alphas", "normals", "normals_from_depth", "distort", "median")
    for name, g, w in zip(names, outs["torch"][:6], outs["jax"][:6]):
        if name == "normals_from_depth":
            continue  # RGB+ED has none
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4, err_msg=name)
    assert float(outs["torch"][4].abs().max()) > 0  # the distortion is rendered


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_render_scene_takes_packed(tmp_path, fast):
    """render_scene(..., packed=True) reaches rasterization through its
    keyword arguments, in both packages."""
    path = str(tmp_path / "ckpt_1.npz")
    p, alive = _write_checkpoint(path)
    inf = GaussianInferenceScene.from_gaussian_scene(load_checkpoint(path, device="cpu"),
                                                     id="ckpt")
    jscene = JScene.from_gaussian_scene(
        JGaussianScene("ckpt", {k: jnp.asarray(v[alive]) for k, v in p.items()}), id="ckpt")
    vm, K = _scene()[5][0], _scene()[6][0]
    tc, ta, tm = render_scene(inf, viewmat=vm, K=K, width=W, height=H, fast=fast, packed=True,
                              isect_capacity=8192)
    jc, ja, jm = jrender_scene(jscene, viewmat=jnp.asarray(vm), K=jnp.asarray(K), width=W,
                               height=H, fast=fast, packed=True, isect_capacity=8192)
    assert int(tm["n_isects"]) == int(jm["n_isects"]) > 0
    if fast:
        # the JAX suite's fast-path class (tests/test_fast_inference.py:62-68)
        d = np.abs(tc.numpy() - np.asarray(jc))
        assert d.mean() < 5e-3 and np.quantile(d, 0.999) < 0.05
    else:
        _band_close(tc.numpy(), jc, "colors")
        _band_close(ta.numpy(), ja, "alphas")
