"""Port parity: any channel count, as the JAX package renders it.

The composites are instantiated for 1 to 32 channels; the wrappers take more
in groups of 32 (`rasterize_kernel.channel_groups`), each group with the
geometry rows.  The same numpy inputs go through the JAX package (Pallas in
interpret mode) and the port on the CPU, whose wrappers take the same groups
through their plain versions.

Tolerances, and why:
- rasterization(): the images in the band of tests/test_torch_rendering.py
  (the JAX suite's), the gradients in the band of tests/test_torch_grads.py
  (3e-4 of max(1, largest entry), 3% of entries may leave it, none by 1e-2);
  with pack_payload and pack_grads, the class and band of
  tests/test_torch_packed.py (the JAX packed kernel's expanded sigma).
- rasterization_2dgs(): 2e-4 for the outputs (tests/test_torch_rasterize2d.py),
  the gradients in the band of tests/test_torch_grads.py.
- rasterization(with_ut=True, with_eval3d=True): the bands of
  tests/test_torch_rasterize_eval3d.py's end-to-end test.
- A grouped render against the single-group renders of the same channels:
  bit for bit.  Gate, stop and T depend on the geometry only, and each
  channel's sum is its own.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.projection import fully_fused_projection as jproj
from gsplat_tpu.rendering import rasterization as jrast
from gsplat_tpu.rendering import rasterization_2dgs as jrast2d
from gsplat_tpu_torch import rasterization as trast
from gsplat_tpu_torch.ops import rasterize2d_kernel as r2k
from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as r3k
from gsplat_tpu_torch.ops import rasterize_kernel as rk
from gsplat_tpu_torch.ops.projection import fully_fused_projection as tproj
from gsplat_tpu_torch.rendering import rasterization_2dgs as trast2d

W, H = 64, 48
ARGS = ("means", "quats", "scales", "opacities", "colors")


def _look_at(eye, target=(0.0, 0.0, 0.0)):
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.stack([right, down, fwd])
    w2c[:3, 3] = -w2c[:3, :3] @ eye
    return w2c


def _scene(D, N=50, seed=0):
    """About 50 gaussians before 2 look-at cameras, D colour channels."""
    rng = np.random.default_rng(seed)
    viewmats = np.stack([_look_at(np.array([3.0 * math.cos(a), 3.0 * math.sin(a), -1.0]))
                         for a in (0.3, 2.0)])
    f = 0.5 * W / math.tan(math.radians(30))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return dict(
        means=rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32),
        quats=rng.standard_normal((N, 4)).astype(np.float32),
        scales=rng.uniform(0.05, 0.2, (N, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, N).astype(np.float32),
        colors=rng.uniform(0, 1, (N, D)).astype(np.float32),
        viewmats=viewmats, Ks=np.stack([K, K]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _band_close(a, b, name, strict=3e-5, frac=0.05, hard=2e-4):
    """The images' band of tests/test_torch_rendering.py."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert float((diff > strict).mean()) < frac, (name, float((diff > strict).mean()))
    assert float(diff.max()) < hard, (name, float(diff.max()))


def _grad_band(got, want, what, tol=3e-4, frac=0.03, hard=1e-2):
    """The gradients' band of tests/test_torch_grads.py (the packed modes:
    tests/test_torch_packed.py's, 5e-3 and 0.1)."""
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    diff = np.abs(got - want)
    assert (diff > tol * scale).mean() < frac, (what, float((diff > tol * scale).mean()))
    assert diff.max() < hard * scale, (what, float(diff.max()))


def _fast_class(a, b, name):
    """tests/test_torch_packed.py's class for the packed forward."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert diff.mean() < 5e-3, (name, diff.mean())
    assert np.quantile(diff, 0.999) < 0.05, (name, np.quantile(diff, 0.999))


def _loss(outs, tgts, xp):
    return sum(xp.sum((o - t) ** 2) for o, t in zip(outs, tgts))


def _both(jfn, tfn, s, tgt_shapes, pick, wh=(W, H), **kw):
    """One loss over `pick(outputs)` through the JAX function (jax.grad) and
    the port (autograd) on the same inputs at `wh`: (port outputs, JAX
    outputs, port gradients, JAX gradients) of ARGS."""
    rng = np.random.default_rng(11)
    tgts = [rng.uniform(0, 1, sh).astype(np.float32) for sh in tgt_shapes]
    cams = (s["viewmats"], s["Ks"])

    def jloss(*x):
        out = jfn(*x[:4], x[4], *(jnp.asarray(c) for c in cams), *wh, **kw)
        return _loss(pick(out), [jnp.asarray(t) for t in tgts], jnp), out

    # one compile of the whole JAX loss: op by op it compiles hundreds of times
    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True))(
        *(jnp.asarray(s[k]) for k in ARGS))
    xs = [_t(s[k]).requires_grad_() for k in ARGS]
    tout = tfn(*xs[:4], xs[4], *(_t(c) for c in cams), *wh, **kw)
    _loss(pick(tout), [torch.from_numpy(t) for t in tgts], torch).backward()
    return tout, jout, [x.grad.numpy() for x in xs], [np.asarray(g) for g in jg]


@pytest.mark.parametrize("mode", ["exact", "packed"])
@pytest.mark.parametrize("D", [33, 64])
def test_rasterization_any_channel_count_matches_jax(D, mode):
    s = _scene(D)
    packed = mode == "packed"
    kw = dict(near_plane=0.01, far_plane=100.0, isect_capacity=8192,
              pack_payload=packed, pack_grads=packed)
    shapes = [(2, H, W, D), (2, H, W, 1)]
    tout, jout, tg, jg = _both(jrast, trast, s, shapes, lambda o: (o[0], 0.3 * o[1]), **kw)
    assert tout[0].shape == (2, H, W, D) and int(tout[2]["n_isects"]) > 0
    img, alpha = tout[0].detach().numpy(), tout[1].detach().numpy()
    if packed:
        _fast_class(img, jout[0], "colors")
        _fast_class(alpha, jout[1], "alphas")
    else:
        _band_close(img, jout[0], "colors")
        _band_close(alpha, jout[1], "alphas")
    band = dict(tol=5e-3, hard=0.1) if packed else {}
    for name, g, w in zip(ARGS, tg, jg):
        assert np.abs(w).max() > 0, name
        _grad_band(g, w, f"D={D} {mode}: {name}", **band)


@pytest.mark.parametrize("D", [32, 40])
def test_rasterization_2dgs_any_channel_count_matches_jax(D):
    """D colour channels and the depth channel (RGB+ED): D + 1 channels, the
    depth in the last group."""
    s = _scene(D, seed=1)
    shapes = [(2, H, W, D + 1), (2, H, W, 1), (2, H, W, 3), (2, H, W, 1)]
    tout, jout, tg, jg = _both(jrast2d, trast2d, s, shapes,
                               lambda o: (o[0], 0.3 * o[1], o[2], o[4]), render_mode="RGB+ED")
    names = ("render", "alphas", "normals", "normals_from_depth", "distort", "median")
    for name, g, w in zip(names, tout[:6], jout[:6]):
        if name == "normals_from_depth":
            continue  # differences of neighbouring depths: tests/test_torch_rasterize2d.py
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=2e-4, err_msg=name)
    for name, g, w in zip(ARGS, tg, jg):
        assert np.abs(w).max() > 0, name
        _grad_band(g, w, f"2DGS D={D}: {name}")


def test_rasterization_eval3d_any_channel_count_matches_jax():
    """40 colour channels through a distorted pinhole, RGB-Ed with normals:
    41 channels, the hit channel and the normals in the last group, at
    32x24 (the JAX op's interpret mode takes most of the time)."""
    D, w, h = 40, 32, 24
    s = _scene(D, N=40, seed=2)
    s["viewmats"], s["Ks"] = s["viewmats"][:1], s["Ks"][:1]
    s["means"][:, 2] += 3.0  # in front of the identity camera
    s["viewmats"] = np.eye(4, dtype=np.float32)[None]
    kw = dict(with_ut=True, with_eval3d=True, render_mode="RGB-Ed", return_normals=True)
    s["Ks"][:, :2] *= 0.5
    shapes = [(1, h, w, D + 1), (1, h, w, 1), (1, h, w, 3)]
    rad = np.array([[0.03, -0.01, 0.0]], np.float32)

    def pick(o):
        return o[0], 0.3 * o[1], 0.1 * o[2]["render_normals"]

    tout, jout, tg, jg = _both(
        lambda *a, **k: jrast(*a, radial_coeffs=jnp.asarray(rad), **k),
        lambda *a, **k: trast(*a, radial_coeffs=_t(rad), **k), s, shapes, pick, wh=(w, h), **kw)
    img, alpha = tout[0].detach(), tout[1].detach()
    assert img.shape == (1, h, w, D + 1) and float(alpha.max()) > 0.5
    np.testing.assert_allclose(img.numpy(), np.asarray(jout[0]), rtol=0,
                               atol=5e-5 * max(1.0, float(np.abs(np.asarray(jout[0])).max())))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jout[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tout[2]["render_normals"].detach().numpy(),
                               np.asarray(jout[2]["render_normals"]), rtol=0, atol=2e-5)
    for name, g, w in zip(ARGS, tg, jg):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4 * max(float(np.abs(w).max()), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("packed", [False, True], ids=["float32", "packed"])
def test_grouped_render_is_the_single_group_renders_bit_for_bit(packed):
    """rasterization() at D = 64 equals, bit for bit, its two halves rendered
    alone (alphas too: every group's T is the first's), and no plain
    version, the kernels' stand-in here, sees more than 32 channels."""
    s = _scene(64, seed=3)
    kw = dict(near_plane=0.01, far_plane=100.0, isect_capacity=8192, pack_payload=packed)

    def render(colors):
        args = [_t(s[k]) for k in ARGS[:4]] + [_t(colors), _t(s["viewmats"]), _t(s["Ks"])]
        with torch.no_grad():
            return trast(*args, W, H, **kw)

    full, alpha, _ = render(s["colors"])
    for c0, c1 in rk.channel_groups(64):
        part, part_alpha, _ = render(s["colors"][:, c0:c1])
        assert torch.equal(full[..., c0:c1], part), (c0, c1)
        assert torch.equal(alpha, part_alpha), (c0, c1)
    assert rk.channel_groups(64) == [(0, 32), (32, 64)]
    assert rk.channel_groups(33) == [(0, 32), (32, 33)]
    assert rk.channel_groups(32) == [(0, 32)]


def test_grouped_2dgs_and_eval3d_renders_are_the_single_group_renders_bit_for_bit():
    """rasterization_2dgs() at 40 colour channels (41 with the depth) against
    its first 32 colours alone (the first group) and its last 8 with the
    depth (the last group, which also gives the normals, the distortion and
    the median); the eval3d path likewise at 40 with the hit channel and
    the normals, against RGB on the first 32 and RGB-Ed with normals on the
    last 8."""
    s = _scene(40, seed=4)
    cams = (_t(s["viewmats"]), _t(s["Ks"]))

    def r2(colors, mode):
        with torch.no_grad():
            return trast2d(*(_t(s[k]) for k in ARGS[:4]), _t(colors), *cams, W, H,
                           render_mode=mode)

    full = r2(s["colors"], "RGB+ED")
    head = r2(s["colors"][:, :32], "RGB")
    tail = r2(s["colors"][:, 32:], "RGB+ED")
    assert torch.equal(full[0][..., :32], head[0]) and torch.equal(full[0][..., 32:], tail[0])
    for k in (1, 2, 4, 5):  # alphas, normals, distortion, median
        assert torch.equal(full[k], tail[k]), k
    assert torch.equal(full[1], head[1])

    e = dict(s)
    e["means"] = s["means"] + np.float32([0, 0, 3])
    vm, K = _t(np.eye(4, dtype=np.float32)[None]), _t(s["Ks"][:1])

    def r3(colors, mode, normals):
        with torch.no_grad():
            img, alpha, meta = trast(*(_t(e[k]) for k in ARGS[:4]), _t(colors), vm, K, W, H,
                                     with_ut=True, with_eval3d=True, render_mode=mode,
                                     return_normals=normals)
        return img, alpha, meta["render_normals"]

    full = r3(e["colors"], "RGB-Ed", True)
    head = r3(e["colors"][:, :32], "RGB", False)
    tail = r3(e["colors"][:, 32:], "RGB-Ed", True)
    assert torch.equal(full[0][..., :32], head[0]) and torch.equal(full[0][..., 32:], tail[0])
    assert torch.equal(full[1], head[1]) and torch.equal(full[1], tail[1])
    assert torch.equal(full[2], tail[2])


def test_wrappers_hand_the_plain_versions_at_most_32_channels(monkeypatch):
    """Forward and backward at D = 64 (3DGS), 41 (2DGS with its depth) and 41
    (eval3d with the hit channel): every call of a plain version, the
    kernels' stand-in on the CPU, takes at most 32 channels."""
    def eval3d_channels(f, a, out):
        return f.shape[0] - r3k.ROW_SCALE - 3 * bool(a[7]) - 3 * bool(a[8])

    channels = {  # the channel count of a call, from its arguments or its output
        (rk, "rasterize_fwd_plain"): lambda f, a, out: out[0].shape[-1],
        (rk, "rasterize_bwd_plain"): lambda f, a, out: a[7].shape[-1],  # v_pix
        (r2k, "rasterize2d_fwd_plain"): lambda f, a, out: f.shape[0] - r2k.N_FIXED_ROWS,
        (r2k, "rasterize2d_bwd_plain"): lambda f, a, out: f.shape[0] - r2k.N_FIXED_ROWS,
        (r3k, "rasterize_eval3d_fwd_plain"): eval3d_channels,
        (r3k, "rasterize_eval3d_bwd_plain"): eval3d_channels,
    }
    seen = []
    for (mod, name), count in channels.items():
        def rec(fields, *a, _orig=getattr(mod, name), _count=count, _name=name, **kw):
            out = _orig(fields, *a, **kw)
            seen.append((_name, _count(fields, a, out)))
            return out

        monkeypatch.setattr(mod, name, rec)
    s = _scene(64, seed=5)
    xs = [_t(s[k]).requires_grad_() for k in ARGS]
    img, alpha, _ = trast(*xs, _t(s["viewmats"]), _t(s["Ks"]), W, H, isect_capacity=8192)
    (img.sum() + alpha.sum()).backward()
    s2 = _scene(40, seed=5)
    out = trast2d(*(_t(s2[k]) for k in ARGS[:4]), _t(s2["colors"]).requires_grad_(),
                  _t(s2["viewmats"]), _t(s2["Ks"]), W, H, render_mode="RGB+ED")
    (out[0].sum() + out[2].sum() + out[4].sum()).backward()
    img, alpha, _ = trast(*(_t(s2[k]) for k in ARGS[:4]), _t(s2["colors"]).requires_grad_(),
                          _t(np.eye(4, dtype=np.float32)[None]), _t(s2["Ks"][:1]), W, H,
                          with_ut=True, with_eval3d=True, render_mode="RGB-Ed")
    img.sum().backward()
    names = {n for n, _ in seen}
    assert len(names) == 6, names
    assert all(1 <= d <= 32 for _, d in seen), seen


def test_projection_refuses_the_lidar_as_jax_does():
    """The EWA projection has no lidar model: both packages raise ValueError,
    and the port names the lidar's route."""
    s = _scene(3)
    args = [s["means"], None, s["quats"], s["scales"], s["viewmats"], s["Ks"], W, H]
    with pytest.raises(ValueError, match="unsupported camera_model"):
        jproj(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
              camera_model="lidar")
    with pytest.raises(ValueError, match="with_eval3d=True"):
        tproj(*(_t(a) if isinstance(a, np.ndarray) else a for a in args), camera_model="lidar")
