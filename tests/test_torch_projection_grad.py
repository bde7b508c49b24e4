"""The training route of the projection and SH colours
(ops/projection_kernel.py:project_shade_grad): the route's choice in
rasterization(), and its plain version (the CPU's stand-in for the forward
and backward kernels) against autograd through the route it replaced.  CPU
only, no JAX; the card's tests of the kernels (tests/test_torch_port_rules.py)
reuse `grad_case`."""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch.ops import projection_kernel as pk
from gsplat_tpu_torch.utils import trace
from test_torch_projection_kernel import (
    H,
    N_DEGENERATE,
    RADIUS_CLIP,
    W,
    _replaced_route,
    project_args,
    projection_scene,
    same_bits,
)

OUTPUTS = ("means2d", "depths", "conics", "op", "feats")
LEAVES = ("means", "quats", "scales", "opacities", "coeffs")
SANITISED = [0, 1, 2, 3, 4, 5, 7]  # projection_scene's rows with a non-finite field or q = 0


def grad_case(N, C, deg, seed=0, device="cpu"):
    """projection_scene's float32 scene (SH coefficients of degree 3, or 4
    for `deg` 4) and seeded cotangents of the five differentiable outputs,
    on `device`."""
    s = projection_scene(N=N, C=C, seed=seed, device=device)
    g = torch.Generator().manual_seed(1000 + 10 * deg + C)
    if deg == 4:
        extra = torch.randn(N, 9, 3, generator=g) * 0.5
        s["coeffs"] = torch.cat([s["coeffs"], extra.to(device)], dim=1)
    shapes = ((C, N, 2), (C, N), (C, N, 3), (C, N), (C, N, 3))
    scale = (1.0, 1.0, 1e-3, 1.0, 1.0)  # conics are ~1e3 times the means2d's scale
    cots = [(torch.randn(sh, generator=g) * k).to(device) for sh, k in zip(shapes, scale)]
    return s, cots


def _grads(fn, s, cots, deg, antialiased):
    """fn's outputs and the gradients of the five leaves for `cots`."""
    leaves = {k: s[k].clone().requires_grad_(True) for k in LEAVES}
    out = fn({**s, **leaves}, deg, antialiased)
    grads = torch.autograd.grad(out[1:], [leaves[k] for k in LEAVES], cots)
    return [o.detach() for o in out], grads


def _project_shade_grad(s, deg, antialiased):
    args, kw = project_args(s, deg, antialiased)
    return pk.project_shade_grad(*args, **kw)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
def test_plain_version_and_its_gradients_are_the_replaced_route(deg, C, antialiased):
    """On CPU tensors project_shade_grad is its plain version under
    autograd: its outputs and the gradients of every leaf equal autograd's
    through the route it replaced, bit for bit, on a scene with sanitised
    rows, rows behind and on the camera plane, culled by the radius clip,
    and SH coefficients of degree 3 rendered at degree `deg`.  Sanitised rows
    get no gradient, coefficient rows past (deg + 1)^2 none, a culled row's
    colour none, while its geometry gets what autograd gives it; the plain
    backward (project_shade_bwd) gives the same gradients."""
    s, cots = grad_case(600, C, deg)
    got, grads = _grads(_project_shade_grad, s, cots, deg, antialiased)
    want, want_grads = _grads(lambda x, d, a: _replaced_route(x, d, a), s, cots, deg,
                              antialiased)
    for name, x, y in zip(("radii",) + OUTPUTS, got, want):
        assert x.shape == y.shape and same_bits(x, y), name
    for name, x, y in zip(LEAVES, grads, want_grads):
        assert x.shape == y.shape and same_bits(x, y), name
    radii = got[0]
    visible = (radii > 0).all(-1)
    assert bool(visible.any()) and not bool(visible[:, :N_DEGENERATE - 3].any())
    for x in grads:
        assert not bool(x[SANITISED].any())
    v_coeffs = grads[4]
    assert not bool(v_coeffs[:, (deg + 1) ** 2:].any())
    assert not bool(v_coeffs[~visible.any(0)].any())
    culled = ~visible.any(0)
    culled[SANITISED] = False
    assert bool(grads[0][culled].any())  # geometry: what autograd gives a culled row
    plain = pk.project_shade_bwd(s["means"], s["quats"], s["scales"], s["opacities"],
                                 s["coeffs"], s["viewmats"], s["Ks"], radii, *cots, W, H,
                                 sh_degree=deg, radius_clip=RADIUS_CLIP,
                                 antialiased=antialiased)
    for name, x, y in zip(LEAVES, plain, grads):
        assert same_bits(x, y), name


def _leaves(s, bf16=False):
    dt = torch.bfloat16 if bf16 else torch.float32
    return {k: s[k].to(dt).clone().requires_grad_(True)
            for k in ("means", "quats", "scales", "opacities", "coeffs")}


def _render(s, leaves, **kw):
    args = dict(means=leaves["means"], quats=leaves["quats"], scales=leaves["scales"],
                opacities=leaves["opacities"], colors=leaves["coeffs"], viewmats=s["viewmats"],
                Ks=s["Ks"], width=W, height=H, sh_degree=3, radius_clip=RADIUS_CLIP,
                isect_capacity=1 << 15)
    args.update(kw)
    return rasterization(**args)


def _routed(call):
    """(rows of the training route, rows of the no-grad route) in `call`,
    which renders and runs the backward of its image."""
    with trace.recording() as rec:
        call()
    rows = lambda name: sum(c.value for c in rec.counters if c.name == name)
    return rows("project.fused_grad"), rows("project.fused")


def _render_and_backward(s, leaves, **kw):
    colors, alphas, meta = _render(s, leaves, **kw)
    (colors.square().sum() + alphas.sum()).backward()
    return colors, alphas, meta


def test_the_trainers_3dgs_call_takes_the_training_route(tmp_path):
    """Trainer.render (MCMC, SH, packed) passes the activations of its
    parameters, which require gradients, with cameras that do not: the
    training route projects every (camera, gaussian) row."""
    from gsplat_tpu_torch.trainer import Config, Trainer

    rng = np.random.default_rng(0)
    vm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    vm[:, 2, 3] = 4.0
    data = dict(means3d=rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32),
                colors=rng.integers(0, 255, (200, 3)).astype(np.uint8), viewmats=vm,
                Ks=np.tile(np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32),
                           (2, 1, 1)), width=np.int64(64), height=np.int64(48))
    tr = Trainer(Config(strategy="mcmc", data="npz", result_dir=str(tmp_path), max_steps=2,
                        sh_degree=1, cap_max=256, isect_capacity=1 << 14, tb_every=0),
                 data=data, device="cpu")
    leaves = {k: p.detach().requires_grad_() for k, p in tr.params.items()}
    vms, Ks = torch.from_numpy(vm[:1]), torch.from_numpy(data["Ks"][:1])

    def step():
        colors, _, _ = tr.render(leaves, tr.alive, vms, Ks, 1)
        colors.sum().backward()

    assert _routed(step) == (tr.capacity, 0)
    assert all(bool(torch.isfinite(p.grad).all()) for p in leaves.values())


@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
def test_a_training_render_equals_the_pytorch_routes(antialiased):
    """The same render and backward through the training route and through
    the PyTorch route (taken when the cameras require a gradient): equal
    images, leaf gradients and screen-space gradient (the means2d_offset
    carrier rides on the route's means2d), bit for bit on CPU tensors."""
    s = projection_scene(N=800, C=2)
    mode = "antialiased" if antialiased else "classic"
    out = []
    for cams_grad in (False, True):
        leaves = _leaves(s)
        off = torch.zeros(2, 800, 2, requires_grad=True)
        vm = s["viewmats"].clone().requires_grad_(cams_grad)
        rows = _routed(lambda: out.append(_render_and_backward(
            s, leaves, viewmats=vm, rasterize_mode=mode, means2d_offset=off)))
        assert rows == ((0, 0) if cams_grad else (2 * 800, 0))
        out[-1] = (out[-1][0].detach(), out[-1][1].detach(), off.grad,
                   *[leaves[k].grad for k in LEAVES])
    for x, y in zip(*out):
        assert torch.equal(x, y)
    assert float(out[0][1].mean()) > 0 and bool(out[0][2].any())


@pytest.mark.parametrize("case", ["viewmats_grad", "covars", "with_ut", "with_eval3d",
                                  "extra_signals", "masks", "batched", "bf16", "non_sh_colors"])
def test_the_training_route_falls_back(case):
    """Calls that need a gradient but lie outside the route's case take the
    PyTorch route and give finite gradients; the same call without the
    case's feature takes the route."""
    s = projection_scene(N=300, C=1)
    leaves = _leaves(s, bf16=case == "bf16")
    kw = {}
    if case == "viewmats_grad":
        kw = dict(viewmats=s["viewmats"].clone().requires_grad_(True))
    elif case == "covars":
        from gsplat_tpu_torch.ops.math import quat_scale_to_covar_preci

        kw = dict(covars=quat_scale_to_covar_preci(leaves["quats"], leaves["scales"], True,
                                                   False)[0], quats=None, scales=None)
    elif case == "with_ut":
        kw = dict(with_ut=True)
    elif case == "with_eval3d":
        kw = dict(with_ut=True, with_eval3d=True)
    elif case == "extra_signals":
        kw = dict(extra_signals=torch.rand(300, 2))
    elif case == "masks":
        kw = dict(masks=torch.ones(1, -(-H // 16), -(-W // 16), dtype=torch.bool))
    elif case == "batched":
        kw = dict(means=leaves["means"][None], quats=leaves["quats"][None],
                  scales=leaves["scales"][None], opacities=leaves["opacities"][None],
                  viewmats=s["viewmats"][None], Ks=s["Ks"][None])
    elif case == "non_sh_colors":
        kw = dict(colors=torch.rand(300, 3, requires_grad=True), sh_degree=None)
    assert _routed(lambda: _render_and_backward(s, leaves, **kw)) == (0, 0)
    keep = slice(N_DEGENERATE, None)  # the sanitised rows' gradients are zero, not NaN
    for k in ("means", "opacities"):
        assert bool(torch.isfinite(leaves[k].grad[keep]).all()), k
    assert _routed(lambda: _render_and_backward(s, _leaves(s))) == (300, 0)


def test_project_shade_grad_checks_its_arguments():
    s = projection_scene(N=50, C=1)
    args, kw = project_args(s, 3, False)
    with pytest.raises(ValueError, match="float32 gaussians"):
        pk.project_shade_grad(s["means"], s["quats"].bfloat16(), *args[2:], **kw)
    with pytest.raises(ValueError, match="viewmats or Ks"):
        pk.project_shade_grad(*args[:5], s["viewmats"].clone().requires_grad_(True),
                              *args[6:], **kw)
    radii = pk.project_shade(*args, **kw)[0]
    with pytest.raises(ValueError, match="radii"):
        pk.project_shade_bwd(*args[:7], radii[..., 0], None, None, None, None, None, W, H)
    with pytest.raises(ValueError, match="cotangent"):
        pk.project_shade_bwd(*args[:7], radii, torch.zeros(1, 50, 3), None, None, None, None,
                             W, H, sh_degree=3)
    with pytest.raises(ValueError, match="SH degree"):
        pk.project_shade_bwd(*args[:7], radii, None, None, None, None, None, W, H)
