"""The one-pass projection of renders that need no gradient
(ops/projection_kernel.py): its plain version against the route it
replaces, the route's choice in rasterization(), and render_scene on a bf16
scene.  CPU only, no JAX; the card's test of the kernel against the plain
version (tests/test_torch_port_rules.py) reuses `projection_scene`."""

import math

import pytest
import torch

from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch.ops import projection_kernel as pk
from gsplat_tpu_torch.ops.projection import fully_fused_projection
from gsplat_tpu_torch.ops.sh import spherical_harmonics
from gsplat_tpu_torch.scene import GaussianInferenceScene, render_scene
from gsplat_tpu_torch.utils import trace

W, H = 320, 240
RADIUS_CLIP = 2.0  # the tiny gaussians' radii straddle it
N_DEGENERATE = 16


def _rot_y(deg):
    a = math.radians(deg)
    return torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                         [-math.sin(a), 0.0, math.cos(a)]])


def projection_scene(N=4000, C=2, dtype=torch.float32, seed=0, device="cpu"):
    """A seeded scene in front of C (1 or 2) cameras, made on the CPU and
    moved to `device`.  Its first rows are degenerate: non-finite means,
    scales, quaternions and opacities, a zero quaternion, opacities under
    and at 1/255, a mean behind camera 0, on its plane (tz = 0) and within
    1e-6 of it, far outside the frustum, past the far plane, a huge and a
    tiny gaussian; the tiny ones of the rest have radii about RADIUS_CLIP.
    Quaternions, scales, opacities and the SH-3 coefficients [N, 16, 3]
    are in `dtype`, means in float32."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    means = (u(N, 3) - 0.5) * torch.tensor([6.0, 5.0, 0.0]) + torch.tensor([0.0, 0.0, 1.0])
    means[:, 2] += u(N) * 7.0
    quats = torch.randn(N, 4, generator=g)
    scales = torch.exp(u(N, 3) * math.log(500.0)) * 1e-4  # 1e-4 to 0.05
    opac = u(N)
    coeffs = torch.randn(N, 16, 3, generator=g) * 0.5
    nan, inf = float("nan"), float("inf")
    means[0, 1] = nan
    means[1, 0] = inf
    scales[2, 2] = nan
    scales[3, 0] = inf
    quats[4] = 0.0
    quats[5, 3] = nan
    opac[6] = 1e-3
    opac[7] = nan
    means[8, 2] = -2.0
    means[9, 2] = 0.0
    means[10, 2] = 5e-7
    means[11] = torch.tensor([1e3, 0.0, 4.0])
    means[12, 2] = 1e11
    opac[13] = 1.0 / 255.0
    scales[14] = 3.0
    scales[15] = 1e-7
    vm = torch.eye(4).repeat(2, 1, 1)
    vm[1, :3, :3] = _rot_y(20.0)
    vm[1, :3, 3] = torch.tensor([0.3, -0.2, 0.5])
    K = torch.tensor([[300.0, 0.0, 160.3], [0.0, 300.0, 119.7], [0.0, 0.0, 1.0]]).repeat(2, 1, 1)
    cast = lambda x: x.to(dtype).to(device)
    return dict(means=means.to(device), quats=cast(quats), scales=cast(scales),
                opacities=cast(opac), coeffs=cast(coeffs), viewmats=vm[:C].to(device),
                Ks=K[:C].to(device))


def same_bits(a, b) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    if a.dtype == torch.float32:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return bool(((a.view(torch.int32) == b.view(torch.int32)) | both_nan).all())
    return torch.equal(a, b)


def _replaced_route(s, deg, antialiased):
    """rendering.rasterization's projection and SH before the one-pass route,
    as it was written there: the sanitisation, fully_fused_projection, the
    opacities, the SH colours at the camera centres, +0.5, >= 0."""
    means, quats, scales, opacities, coeffs = (
        s[k].float() for k in ("means", "quats", "scales", "opacities", "coeffs"))
    viewmats, Ks = s["viewmats"], s["Ks"]
    C, N = viewmats.shape[0], means.shape[0]
    ok_in = torch.isfinite(means).all(dim=-1)
    ok_in &= torch.isfinite(quats).all(dim=-1)
    ok_in &= torch.sum(quats * quats, dim=-1) > 1e-24
    ok_in &= torch.isfinite(scales).all(dim=-1)
    ok_in &= torch.isfinite(opacities)
    okc = ok_in[..., None]
    means = torch.where(okc, means, 0.0)
    unit_q = torch.zeros_like(quats)
    unit_q[..., 0] = 1.0
    quats = torch.where(okc, quats, unit_q)
    scales = torch.where(okc, scales, 1.0)
    opacities = torch.where(ok_in, opacities, 0.0)
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, None, quats, scales, viewmats, Ks, W, H, eps2d=0.3, near_plane=0.01,
        far_plane=1e10, radius_clip=RADIUS_CLIP, calc_compensations=antialiased,
        opacities=opacities,
    )
    op = opacities[..., None, :].expand((C, N)).reshape(C, N)
    if antialiased:
        op = op * compensations.reshape(C, N)
    R = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    campos = -(R * t[..., :, None]).sum(dim=-2)
    dirs = means[..., None, :, :] - campos[..., None, :]
    colors = spherical_harmonics(deg, dirs, coeffs, masks=(radii > 0).all(dim=-1))
    return radii, means2d, depths, conics, op, torch.clamp(colors + 0.5, min=0.0)


def project_args(s, deg, antialiased):
    return ((s["means"], s["quats"], s["scales"], s["opacities"], s["coeffs"], s["viewmats"],
             s["Ks"], W, H),
            dict(sh_degree=deg, near_plane=0.01, far_plane=1e10, radius_clip=RADIUS_CLIP,
                 antialiased=antialiased))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
def test_plain_version_is_the_replaced_route(dtype, deg, antialiased):
    s = projection_scene(N=600, C=2, dtype=dtype)
    args, kw = project_args(s, deg, antialiased)
    got = pk.project_shade(*args, **kw)  # CPU tensors: the plain version
    want = _replaced_route(s, deg, antialiased)
    for name, x, y in zip(("radii", "means2d", "depths", "conics", "op", "feats"), got, want):
        assert x.shape == y.shape and same_bits(x, y), name
    radii = got[0]
    assert not bool((radii[:, :N_DEGENERATE - 3] > 0).any())  # 13, 14, 15 may be seen
    assert bool((radii > 0).all(-1).any())


def _scene_call(s, fast=True, **kw):
    args = dict(means=s["means"], quats=s["quats"], scales=s["scales"],
                opacities=s["opacities"], colors=s["coeffs"], viewmats=s["viewmats"],
                Ks=s["Ks"], width=W, height=H, sh_degree=3, radius_clip=RADIUS_CLIP,
                fast=fast)
    args.update(kw)
    return args


def _fused_rows(call) -> float:
    with trace.recording() as rec:
        out = call()
    return sum(c.value for c in rec.counters if c.name == "project.fused"), out


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_no_grad_route_equals_the_differentiable_route(fast):
    """The same call under no_grad (the one-pass route) and with inputs that
    require grad (the differentiable route) on CPU tensors."""
    s = projection_scene(N=800, C=2)
    rows, (c0, a0, m0) = _fused_rows(lambda: _no_grad_call(s, fast=fast))
    assert rows == 2 * 800
    leaves = {k: s[k].clone().requires_grad_(True) for k in ("means", "quats", "scales")}
    rows, (c1, a1, m1) = _fused_rows(lambda: rasterization(**_scene_call({**s, **leaves},
                                                                         fast=fast)))
    assert rows == 0
    assert torch.equal(c0, c1.detach()) and torch.equal(a0, a1.detach())
    for k in ("radii", "means2d", "depths", "conics", "opacities", "n_isects"):
        assert torch.equal(m0[k], m1[k].detach()), k
    assert float(a0.mean()) > 0


@pytest.mark.parametrize("case", ["covars", "fisheye", "with_ut", "means2d_offset",
                                  "requires_grad", "batched"])
def test_the_route_falls_back(case):
    s = projection_scene(N=300, C=1)
    kw = {}
    if case == "covars":
        from gsplat_tpu_torch.ops.math import quat_scale_to_covar_preci

        kw = dict(covars=quat_scale_to_covar_preci(s["quats"], s["scales"], True, False)[0],
                  quats=None, scales=None)
    elif case == "fisheye":
        kw = dict(camera_model="fisheye", fast=False)
    elif case == "with_ut":
        kw = dict(with_ut=True)
    elif case == "means2d_offset":
        kw = dict(means2d_offset=torch.zeros(1, 300, 2), fast=False)
    elif case == "requires_grad":
        kw = dict(opacities=s["opacities"].clone().requires_grad_(True), fast=False)
    else:
        kw = dict(means=s["means"][None], quats=s["quats"][None], scales=s["scales"][None],
                  opacities=s["opacities"][None], viewmats=s["viewmats"][None],
                  Ks=s["Ks"][None], colors=s["coeffs"])
    rows, (colors, alphas, _) = _fused_rows(lambda: rasterization(**_scene_call(s, **kw)))
    assert rows == 0
    assert bool(torch.isfinite(colors).all()) and bool(torch.isfinite(alphas).all())
    base_kw = {k: v for k, v in kw.items() if k == "fast"}
    rows, _ = _fused_rows(lambda: _no_grad_call(s, **base_kw))
    assert rows == 300  # the same call without the case's feature takes the route


def _no_grad_call(s, **kw):
    with torch.no_grad():
        return rasterization(**_scene_call(s, **kw))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
@pytest.mark.parametrize("compression", ["none", "16b"])
def test_render_scene_on_a_bf16_scene_gives_the_widened_image(fast, compression):
    """render_scene hands the stored bf16 fields to rasterization; the
    image equals the one from the fields widened to f32 first (what
    render_scene passed before), bit for bit."""
    s = projection_scene(N=800, C=1)
    keep = slice(N_DEGENERATE, None)  # a scene's fields are finite
    q = s["quats"][keep]
    scene = GaussianInferenceScene.from_gaussian_tensors(
        s["means"][keep], q / torch.linalg.vector_norm(q, dim=-1, keepdim=True),
        s["scales"][keep], s["opacities"][keep], s["coeffs"][keep], 3, compression,
        id="bf16", device="cpu")
    kw = dict(width=W, height=H, radius_clip=RADIUS_CLIP)
    got = render_scene(scene, viewmat=s["viewmats"][0], K=s["Ks"][0], fast=fast, **kw)
    f32 = lambda k: scene.get(k).float()
    with torch.no_grad():
        want = rasterization(f32("means"), f32("quats"), f32("scales"), f32("opacities"),
                             f32("colors"), s["viewmats"], s["Ks"], sh_degree=3, fast=fast,
                             **kw)
    assert scene.get("quats").dtype == torch.bfloat16
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1].mean()) > 0


def test_project_shade_checks_its_arguments():
    s = projection_scene(N=50, C=1)
    args, kw = project_args(s, 3, False)
    with pytest.raises(ValueError, match="needs 25 coefficients"):
        pk.project_shade(*args, **dict(kw, sh_degree=4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pk.project_shade(s["means"].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="viewmats"):
        pk.project_shade(*args[:5], s["viewmats"][0], *args[6:], **kw)
