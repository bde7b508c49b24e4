"""Port parity: the inference fast path end to end against the JAX package:
rasterization(fast=True) on the pinhole and UT-projection paths,
render_scene's fast default, the inference scene's builders, and the
sample_inference example.

The same numpy inputs go through the JAX package (Pallas in interpret mode
on the CPU) and through the port on the CPU.  Images are held to the JAX
suite's class for the fast path, mean < 5e-3 and 99.9% < 0.05
(tests/test_fast_inference.py:62-68), against the JAX fast path and against
the port's exact path; tests/test_torch_packed.py says why the exact path's
band does not hold against the JAX fast kernel.
"""

import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.rendering import rasterization as jrast
from gsplat_tpu.scene import GaussianInferenceScene as JScene
from gsplat_tpu.scene import render_scene as jrender_scene
from gsplat_tpu_torch import rasterization as trast
from gsplat_tpu_torch.scene import GaussianInferenceScene, render_scene


def _t(x):
    return torch.from_numpy(np.array(x))


def _fast_class(a, b, name):
    """The JAX suite's class for the fast path (test_fast_inference.py:62-68)."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert diff.mean() < 5e-3, (name, diff.mean())
    assert np.quantile(diff, 0.999) < 0.05, (name, np.quantile(diff, 0.999))


RW, RH = 48, 40


def _look_at(eye):
    fwd = -np.asarray(eye, np.float64) / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def _world(N=150, seed=0, sh_degree=3):
    rng = np.random.default_rng(seed)
    f = 0.5 * RW / math.tan(math.radians(30))
    K = np.array([[f, 0, RW / 2], [0, f, RH / 2], [0, 0, 1]], np.float32)
    return dict(
        means=rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32),
        quats=rng.standard_normal((N, 4)).astype(np.float32),
        scales=rng.uniform(0.02, 0.12, (N, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (N,)).astype(np.float32),
        colors=(rng.standard_normal((N, (sh_degree + 1) ** 2, 3)) * 0.3).astype(np.float32),
        viewmats=np.stack([_look_at(np.array([3.0 * math.cos(a), 3.0 * math.sin(a), -1.0]))
                           for a in (0.3, 2.0)]),
        Ks=np.stack([K, K]),
    )


@pytest.mark.parametrize("with_ut", [False, True], ids=["pinhole", "with_ut"])
def test_rasterization_fast_matches_jax(with_ut):
    w = _world()
    keys = ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")
    kw = dict(sh_degree=3, isect_capacity=8192, fast=True, with_ut=with_ut)
    jc, ja, jm = jrast(*(jnp.asarray(w[k]) for k in keys), RW, RH, **kw)
    tc, ta, tm = trast(*(_t(w[k]) for k in keys), RW, RH, **kw)
    assert tc.shape == jc.shape == (2, RH, RW, 3)
    assert int(tm["n_isects"]) == int(jm["n_isects"]) > 0
    np.testing.assert_array_equal(tm["radii"].numpy(), np.asarray(jm["radii"]))
    assert (tm["tiles_per_gauss"] == 0).all() and tm["tiles_per_gauss"].shape == (2, 150)
    _fast_class(tc.numpy(), jc, "colors")
    _fast_class(ta.numpy(), ja, "alphas")
    ec, ea, _ = trast(*(_t(w[k]) for k in keys), RW, RH, **{**kw, "fast": False})
    _fast_class(tc.numpy(), ec.numpy(), "colors against the exact path")
    assert not tc.requires_grad
    # a screen-space carrier runs too (it gets no gradient on this path)
    oc, _, _ = trast(*(_t(w[k]) for k in keys), RW, RH, **kw,
                     means2d_offset=torch.zeros(2, 150, 2, requires_grad=True))
    assert torch.equal(oc, tc)


@pytest.mark.parametrize("with_ut", [False, True], ids=["pinhole", "with_ut"])
def test_rasterization_passes_the_pack_flags_through(with_ut):
    """pack_payload renders the fast path's image (the same packed payload)
    and differentiates it; pack_grads alone keeps the exact image."""
    w = _world()
    keys = ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")
    kw = dict(sh_degree=3, isect_capacity=8192, with_ut=with_ut)
    fast, _, _ = trast(*(_t(w[k]) for k in keys), RW, RH, fast=True, **kw)
    exact, _, _ = trast(*(_t(w[k]) for k in keys), RW, RH, **kw)
    for flags, want in ((dict(pack_payload=True), fast), (dict(pack_grads=True), exact),
                        (dict(pack_payload=True, pack_grads=True), fast)):
        leaves = {k: _t(w[k]).requires_grad_() for k in keys[:5]}
        c, a, _ = trast(*leaves.values(), _t(w["viewmats"]), _t(w["Ks"]), RW, RH, **kw, **flags)
        assert torch.equal(c.detach(), want), flags
        (c.sum() + a.sum()).backward()
        for k, x in leaves.items():
            assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0, (flags, k)


def _inference_scenes(sh_compression="none", seed=0):
    w = _world(seed=seed)
    q = w["quats"] / np.linalg.norm(w["quats"], axis=-1, keepdims=True)
    args = (w["means"], q, w["scales"], w["opacities"], w["colors"])
    js = JScene.from_gaussian_tensors(*map(jnp.asarray, args), 3, sh_compression, id="s")
    ts = GaussianInferenceScene.from_gaussian_tensors(*args, 3, sh_compression, id="s",
                                                      device="cpu")
    return w, js, ts


@pytest.mark.parametrize("sh_compression", ["none", "16b"])
def test_render_scene_fast_default_matches_jax(sh_compression):
    w, js, ts = _inference_scenes(sh_compression)
    assert ts.sh_compression == sh_compression
    assert ts.get("colors").dtype == (torch.bfloat16 if sh_compression == "16b" else torch.float32)
    np.testing.assert_array_equal(ts.get("colors").float().numpy(),
                                  np.asarray(js.get("colors"), np.float32))
    for vm, K in zip(w["viewmats"], w["Ks"]):
        jc, ja, jm = jrender_scene(js, viewmat=jnp.asarray(vm), K=jnp.asarray(K), width=RW,
                                   height=RH, isect_capacity=8192)
        tc, ta, tm = render_scene(ts, viewmat=vm, K=K, width=RW, height=RH, isect_capacity=8192)
        assert tm["render_path"] == "inference" and int(tm["n_isects"]) == int(jm["n_isects"])
        assert (tm["tiles_per_gauss"] == 0).all()  # the fast path's meta
        _fast_class(tc.numpy(), jc, "colors")
        _fast_class(ta.numpy(), ja, "alphas")
        ec, _, em = render_scene(ts, viewmat=vm, K=K, width=RW, height=RH, isect_capacity=8192,
                                 fast=False)
        _fast_class(tc.numpy(), ec.numpy(), "colors against the exact path")
        assert int(em["tiles_per_gauss"].sum()) > 0
    # the depth modes take the exact path, as in the JAX package
    dc, _, _ = render_scene(ts, viewmat=w["viewmats"][0], K=w["Ks"][0], width=RW, height=RH,
                            render_mode="D", isect_capacity=8192)
    assert dc.shape == (1, RH, RW, 1)


@pytest.mark.parametrize("bad", ["means", "scales", "opacities", "quats", "sh_degree",
                                 "compression"])
def test_from_gaussian_tensors_refuses_what_the_jax_builder_refuses(bad):
    w = _world(N=20)
    q = w["quats"] / np.linalg.norm(w["quats"], axis=-1, keepdims=True)
    args = dict(means=w["means"], quats=q, scales=w["scales"], opacities=w["opacities"],
                colors=w["colors"], sh_degree=3, sh_compression="none")
    if bad == "means":
        args["means"] = w["means"][:, :2]
    elif bad == "scales":
        args["scales"] = np.log(w["scales"])  # not activated: negative
    elif bad == "opacities":
        args["opacities"] = w["opacities"] * 4.0 - 2.0
    elif bad == "quats":
        args["quats"] = w["quats"] * 2.0
    elif bad == "sh_degree":
        args["sh_degree"] = 2
    else:
        args["sh_compression"] = "32b"
    jargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in args.items()}
    with pytest.raises(ValueError):
        JScene.from_gaussian_tensors(**jargs, id="s")
    with pytest.raises(ValueError):
        GaussianInferenceScene.from_gaussian_tensors(**args, id="s", device="cpu")


def test_a_released_scene_raises():
    w, js, ts = _inference_scenes()
    assert not ts.is_empty and ts.num_gaussians == 150
    ts.release()
    js.release()
    assert ts.is_empty and js.is_empty
    with pytest.raises(ValueError, match="released"):
        render_scene(ts, viewmat=w["viewmats"][0], K=w["Ks"][0], width=RW, height=RH)
    with pytest.raises(ValueError, match="released"):
        ts.get("means")


def _read_png(path):
    """(width, height, rows) of an 8-bit RGB PNG of one IDAT chunk."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, i = {}, 8
    while i < len(data):
        n = int.from_bytes(data[i : i + 4], "big")
        tag, body = data[i + 4 : i + 8], data[i + 8 : i + 8 + n]
        assert zlib.crc32(tag + body) == int.from_bytes(data[i + 8 + n : i + 12 + n], "big")
        chunks[tag] = body
        i += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()  # no row filter
    return w, h, raw[:, 1:].reshape(h, w, 3)


def test_sample_inference_example_renders_an_npz_checkpoint(tmp_path):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import sample_inference_torch

    rng = np.random.default_rng(4)
    cap, n = 180, 150
    p = {"means": rng.uniform(-1, 1, (cap, 3)), "quats": rng.standard_normal((cap, 4)),
         "scales": np.log(rng.uniform(0.02, 0.12, (cap, 3))), "opacities": rng.normal(0, 1.5, cap),
         "sh0": rng.standard_normal((cap, 1, 3)) * 0.5,
         "shN": rng.standard_normal((cap, 15, 3)) * 0.1}
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    ckpt = tmp_path / "ckpt_9.npz"
    np.savez(ckpt, alive=alive, **{f"p_{k}": v.astype(np.float32) for k, v in p.items()})
    outs = sample_inference_torch.main(["--ckpt", str(ckpt), "--output-dir", str(tmp_path / "png"),
                                        "--n-views", "2", "--width", "48", "--height", "32",
                                        "--isect-capacity", "8192", "--device", "cpu"])
    assert len(outs) == 2
    for out in outs:
        w, h, img = _read_png(out)
        assert (w, h) == (48, 32) and img.max() > 0
    # the .ply of the same alive rows (the trainers' save_ply) renders the same images
    from gsplat_tpu_torch.exporter import export_splats

    export_splats(**{k: v[alive] for k, v in p.items()}, format="ply",
                  save_to=str(tmp_path / "scene.ply"))
    outs_ply = sample_inference_torch.main([
        "--ckpt", str(tmp_path / "scene.ply"), "--output-dir", str(tmp_path / "png_ply"),
        "--n-views", "2", "--width", "48", "--height", "32", "--isect-capacity", "8192",
        "--device", "cpu"])
    for a, b in zip(outs, outs_ply):
        assert np.array_equal(_read_png(a)[2], _read_png(b)[2])
