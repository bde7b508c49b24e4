"""The projection and SH colours in one pass, and its backward: wrappers for
`csrc/projection_fwd.cu` and `csrc/projection_bwd.cu`, the training route's
autograd Function that joins them, and the pieces of the plain route that
the differentiable route shares.

Replaces no Pallas kernel: the JAX package leaves projection and SH, and
their gradients, to XLA (gsplat_tpu/rendering.py:rasterization,
gsplat_tpu/ops/projection.py).  The plain version, `project_shade_plain`, is
that route composed: the degenerate-input sanitisation (`sanitize`),
`fully_fused_projection`, the opacity times the compensation, and the SH
colours (`sh_colors`) plus 0.5 clamped at 0.  rendering.rasterization's
PyTorch route calls the same `sanitize` and `sh_colors`.

Two routes of rendering.rasterization take the pass.  A render that needs
no gradient calls `project_shade`.  A training render (float32 fields that
require a gradient, cameras that do not) calls `project_shade_grad`: on
CUDA tensors an autograd Function whose forward is `project_shade`'s kernel
and whose backward, `project_shade_bwd`, replays each gaussian's forward
from the saved inputs and radii and differentiates it in one more kernel;
on CPU tensors, the plain version under autograd, which is also the plain
version of the backward (`project_shade_bwd_plain`).  On a CUDA tensor
each wrapper launches its kernel (or raises); the plain versions run only
for CPU tensors.  Launches are counted in `project_shade.launches` and
`project_shade_bwd.launches`.

The forward kernel rounds each operation as PyTorch does on the card
(csrc/projection.cuh), so its radii, means2d, depths, conics and opacities
equal the plain version's there bit for bit; its colours, whose SH sums
follow PyTorch's order too, are held to 1e-5.  bfloat16 fields are read as
they are stored and widened in registers, which is exact, where the plain
version widens them first.  The backward follows autograd's conventions at
every clamp, tie and mask, and sums in float32 in its own order: its
gradients agree with autograd's to a relative tolerance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from .._device import check_kernel_device
from .projection import fully_fused_projection
from .sh import num_sh_bases, spherical_harmonics

FIELD_DTYPES = (torch.float32, torch.bfloat16)  # the kernel reads either for any field


def widen(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bfloat16 tensor as float32 (exact); any other tensor as it is."""
    return x.float() if x is not None and x.dtype == torch.bfloat16 else x


def sanitize(means, quats, scales, opacities, covars=None):
    """Degenerate-input sanitisation: rows with a non-finite input or a zero
    quaternion become a safe zero-opacity gaussian before any math (the unit
    gaussian at the origin, or the identity covariance), which the alpha
    cull removes.  Returns (means, quats, scales, opacities, covars)."""
    ok_in = torch.isfinite(means).all(dim=-1)
    if quats is not None:
        ok_in &= torch.isfinite(quats).all(dim=-1)
        ok_in &= torch.sum(quats * quats, dim=-1) > 1e-24
    if scales is not None:
        ok_in &= torch.isfinite(scales).all(dim=-1)
    if covars is not None:
        flat = covars.reshape(covars.shape[: means.dim() - 1] + (-1,))
        ok_in &= torch.isfinite(flat).all(dim=-1)
    ok_in &= torch.isfinite(opacities)
    okc = ok_in[..., None]
    means = torch.where(okc, means, 0.0)
    if quats is not None:
        unit_q = torch.zeros_like(quats)
        unit_q[..., 0] = 1.0
        quats = torch.where(okc, quats, unit_q)
    if scales is not None:
        scales = torch.where(okc, scales, 1.0)
    if covars is not None:
        if covars.shape[-2:] == (3, 3):
            eye = torch.eye(3, dtype=covars.dtype, device=covars.device).expand(covars.shape)
            covars = torch.where(okc[..., None], covars, eye)
        else:
            eye = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=covars.dtype,
                               device=covars.device)
            covars = torch.where(okc, covars, eye)
    opacities = torch.where(ok_in, opacities, 0.0)  # 0 < 1/255 -> culled
    return means, quats, scales, opacities, covars


def campos_from_viewmats(viewmats: torch.Tensor) -> torch.Tensor:
    """Camera centres [..., C, 3] from world-to-camera matrices: -R^T t,
    written elementwise (no TF32 product)."""
    R = viewmats[..., :3, :3]
    t = viewmats[..., :3, 3]
    return -(R * t[..., :, None]).sum(dim=-2)


def sh_colors(degree: int, coeffs: torch.Tensor, means: torch.Tensor, viewmats: torch.Tensor,
              radii: torch.Tensor) -> torch.Tensor:
    """SH colours [..., C, N, D] of `coeffs` at each camera's view
    directions (the mean minus the camera centre), zero where `radii` cull
    the row; before the caller's +0.5."""
    dirs = means[..., None, :, :] - campos_from_viewmats(viewmats)[..., None, :]
    return spherical_harmonics(degree, dirs, coeffs, masks=(radii > 0).all(dim=-1))


def project_shade_plain(
    means, quats, scales, opacities, coeffs, viewmats, Ks, width: int, height: int,
    sh_degree: Optional[int] = None, eps2d: float = 0.3, near_plane: float = 0.01,
    far_plane: float = 1e10, radius_clip: float = 0.0, antialiased: bool = False,
):
    """Plain version of the kernel: the differentiable route's own
    functions, in its order (see `project_shade`)."""
    means, quats, scales, opacities, coeffs = map(widen, (means, quats, scales, opacities, coeffs))
    means, quats, scales, opacities, _ = sanitize(means, quats, scales, opacities)
    radii, means2d, depths, conics, comp = fully_fused_projection(
        means, None, quats, scales, viewmats, Ks, width, height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        calc_compensations=antialiased, opacities=opacities,
    )
    op = opacities[None, :].expand(depths.shape)
    if antialiased:
        op = op * comp
    feats = None
    if coeffs is not None:
        feats = torch.clamp(sh_colors(sh_degree, coeffs, means, viewmats, radii) + 0.5, min=0.0)
    return radii, means2d, depths, conics, op, feats


def _check_coeffs(coeffs: Optional[torch.Tensor], N: int, sh_degree: Optional[int]) -> None:
    if coeffs is None:
        return
    if coeffs.dim() != 3 or coeffs.shape[0] != N or coeffs.shape[2] != 3:
        raise ValueError(f"coeffs must be [N, K, 3], got {tuple(coeffs.shape)}")
    if sh_degree is None or not 0 <= sh_degree <= 4:
        raise ValueError(f"coeffs need an SH degree in [0, 4], got {sh_degree}")
    if num_sh_bases(sh_degree) > coeffs.shape[1]:
        raise ValueError(f"degree {sh_degree} needs {num_sh_bases(sh_degree)} coefficients, "
                         f"got {coeffs.shape[1]}")


def project_shade(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    coeffs: Optional[torch.Tensor],  # [N, K, 3] SH coefficients, or None
    viewmats: torch.Tensor,  # [C, 4, 4] float32
    Ks: torch.Tensor,  # [C, 3, 3] float32
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    antialiased: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """Sanitise, project (pinhole EWA), cull and shade each (camera,
    gaussian), as the differentiable route does, without autograd.

    Returns (radii int32 [C, N, 2], means2d [C, N, 2], depths [C, N],
    conics [C, N, 3], opacities [C, N] (times the compensation when
    `antialiased`), feats [C, N, 3]: the SH colours of degree `sh_degree`
    plus 0.5, clamped at 0, or None without `coeffs`).  The gaussians'
    fields are float32 or bfloat16 each."""
    N = means.shape[0]
    C = viewmats.shape[0]
    if means.shape != (N, 3) or quats.shape != (N, 4) or scales.shape != (N, 3) \
            or opacities.shape != (N,):
        raise ValueError("project_shade takes means [N, 3], quats [N, 4], scales [N, 3] and "
                         "opacities [N]")
    if viewmats.shape != (C, 4, 4) or Ks.shape != (C, 3, 3) \
            or viewmats.dtype != torch.float32 or Ks.dtype != torch.float32:
        raise ValueError("project_shade takes float32 viewmats [C, 4, 4] and Ks [C, 3, 3]")
    fields = (means, quats, scales, opacities, coeffs)
    if any(t is not None and t.dtype not in FIELD_DTYPES for t in fields):
        raise ValueError("project_shade takes float32 or bfloat16 gaussians")
    _check_coeffs(coeffs, N, sh_degree)
    if not check_kernel_device("project_shade", *fields, viewmats, Ks):
        return project_shade_plain(means, quats, scales, opacities, coeffs, viewmats, Ks, width,
                                   height, sh_degree, eps2d, near_plane, far_plane, radius_clip,
                                   antialiased)
    lib = _build.load("projection_fwd")
    means, quats, scales, opacities, viewmats, Ks = (
        t.contiguous() for t in (means, quats, scales, opacities, viewmats, Ks))
    bf16 = sum(bit for bit, t in zip((1, 2, 4, 8, 16), fields)
               if t is not None and t.dtype == torch.bfloat16)
    K = vec = 0
    if coeffs is not None:
        coeffs = coeffs.contiguous()
        K = coeffs.shape[1]
        vec = int((K * 3 * coeffs.element_size()) % 16 == 0 and coeffs.data_ptr() % 16 == 0)
    dev = means.device
    f32 = dict(dtype=torch.float32, device=dev)
    radii = torch.empty((C, N, 2), dtype=torch.int32, device=dev)
    means2d = torch.empty((C, N, 2), **f32)
    depths = torch.empty((C, N), **f32)
    conics = torch.empty((C, N, 3), **f32)
    op = torch.empty((C, N), **f32)
    feats = torch.empty((C, N, 3), **f32) if coeffs is not None else None
    code = lib.gs_project_shade(
        means.data_ptr(), quats.data_ptr(), scales.data_ptr(), opacities.data_ptr(),
        coeffs.data_ptr() if coeffs is not None else None, viewmats.data_ptr(), Ks.data_ptr(),
        N, C, K, -1 if sh_degree is None else sh_degree, bf16, vec, width, height, eps2d,
        near_plane, far_plane, radius_clip, int(antialiased), radii.data_ptr(),
        means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(), op.data_ptr(),
        feats.data_ptr() if feats is not None else None, _build.stream_of(radii),
    )
    _build.check(lib, code, "project_shade")
    project_shade.launches += 1
    return radii, means2d, depths, conics, op, feats


project_shade.launches = 0


def _cotangent(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def project_shade_bwd_plain(
    means, quats, scales, opacities, coeffs, viewmats, Ks, radii, v_means2d, v_depths,
    v_conics, v_op, v_feats, width: int, height: int, sh_degree: Optional[int] = None,
    eps2d: float = 0.3, near_plane: float = 0.01, far_plane: float = 1e10,
    radius_clip: float = 0.0, antialiased: bool = False,
):
    """Plain version of the backward kernel: autograd through
    `project_shade_plain`, whose replay recomputes the forward's `radii`
    (unread here).  Cotangents may be None (zero)."""
    fields = [t.detach().requires_grad_(True) if t is not None else None
              for t in (means, quats, scales, opacities, coeffs)]
    with torch.enable_grad():
        out = project_shade_plain(*fields, viewmats, Ks, width, height, sh_degree, eps2d,
                                  near_plane, far_plane, radius_clip, antialiased)
    pairs = [(o, v) for o, v in zip(out[1:], (v_means2d, v_depths, v_conics, v_op, v_feats))
             if o is not None and v is not None]
    leaves = [t for t in fields if t is not None]
    if not pairs:
        return tuple(torch.zeros_like(t) for t in leaves) + ((None,) if coeffs is None else ())
    grads = torch.autograd.grad([o for o, _ in pairs], leaves, [v for _, v in pairs],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return tuple(grads) + ((None,) if coeffs is None else ())


def project_shade_bwd(
    means: torch.Tensor,  # [N, 3] float32
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    coeffs: Optional[torch.Tensor],  # [N, K, 3], or None
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    radii: torch.Tensor,  # [C, N, 2] int32, the forward's
    v_means2d: Optional[torch.Tensor],  # [C, N, 2] cotangents, None for zero
    v_depths: Optional[torch.Tensor],  # [C, N]
    v_conics: Optional[torch.Tensor],  # [C, N, 3]
    v_op: Optional[torch.Tensor],  # [C, N]
    v_feats: Optional[torch.Tensor],  # [C, N, 3]
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    antialiased: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of `project_shade`'s float32 inputs (means, quats,
    scales, opacities, coeffs or None) from the cotangents of its outputs
    (means2d, depths, conics, opacities, feats), as autograd takes them
    through the plain route: a sanitised row gets none, a row the forward
    culled none through its colour, coefficient rows past
    (sh_degree + 1)^2 none.  `radii` are the forward's; the kernel replays
    the rest from the inputs (`near_plane`, `far_plane` and `radius_clip`
    only decided the radii)."""
    N, C = means.shape[0], viewmats.shape[0]
    fields = (means, quats, scales, opacities, coeffs)
    if any(t is not None and t.dtype != torch.float32 for t in fields):
        raise ValueError("project_shade_bwd takes float32 gaussians")
    if radii.shape != (C, N, 2) or radii.dtype != torch.int32:
        raise ValueError(f"radii must be int32 [C, N, 2], got {tuple(radii.shape)}")
    _check_coeffs(coeffs, N, sh_degree)
    cots = tuple(map(_cotangent, (v_means2d, v_depths, v_conics, v_op, v_feats)))
    for v, shape in zip(cots, ((C, N, 2), (C, N), (C, N, 3), (C, N), (C, N, 3))):
        if v is not None and v.shape != shape:
            raise ValueError(f"a cotangent of shape {tuple(v.shape)} where {shape} belongs")
    if not check_kernel_device("project_shade_bwd", *fields, viewmats, Ks, radii,
                               *cots):
        return project_shade_bwd_plain(means, quats, scales, opacities, coeffs, viewmats, Ks,
                                       radii, *cots, width, height, sh_degree, eps2d,
                                       near_plane, far_plane, radius_clip, antialiased)
    if C == 0:
        return tuple(None if t is None else torch.zeros_like(t) for t in fields)
    lib = _build.load("projection_bwd")
    means, quats, scales, opacities, viewmats, Ks, radii = (
        t.contiguous() for t in (means, quats, scales, opacities, viewmats, Ks, radii))
    g_means, g_quats, g_scales, g_opac = (
        torch.empty_like(t) for t in (means, quats, scales, opacities))
    g_coeffs, K, vec = None, 0, 0
    if coeffs is not None:
        coeffs = coeffs.contiguous()
        K = coeffs.shape[1]
        g_coeffs = torch.empty_like(coeffs)
        vec = int(K * 3 % 4 == 0 and coeffs.data_ptr() % 16 == 0
                  and g_coeffs.data_ptr() % 16 == 0)
    ptr = lambda t: t.data_ptr() if t is not None else None
    code = lib.gs_project_shade_bwd(
        means.data_ptr(), quats.data_ptr(), scales.data_ptr(), opacities.data_ptr(), ptr(coeffs),
        viewmats.data_ptr(), Ks.data_ptr(), radii.data_ptr(), *map(ptr, cots), N, C, K,
        -1 if sh_degree is None else sh_degree, vec, width, height, eps2d, int(antialiased),
        g_means.data_ptr(), g_quats.data_ptr(), g_scales.data_ptr(), g_opac.data_ptr(),
        ptr(g_coeffs), _build.stream_of(g_means),
    )
    _build.check(lib, code, "project_shade_bwd")
    project_shade_bwd.launches += 1
    return g_means, g_quats, g_scales, g_opac, g_coeffs


project_shade_bwd.launches = 0


class _ProjectShade(torch.autograd.Function):
    """`project_shade_grad` on CUDA tensors: the forward pass's kernel, and
    the backward kernel, which needs only the inputs and the radii saved."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, coeffs, viewmats, Ks, settings):
        out = project_shade(means, quats, scales, opacities, coeffs, viewmats, Ks, *settings)
        ctx.settings = settings
        ctx.save_for_backward(means, quats, scales, opacities, coeffs, viewmats, Ks, out[0])
        ctx.mark_non_differentiable(out[0])
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, _v_radii, v_means2d, v_depths, v_conics, v_op, v_feats):
        *inputs, radii = ctx.saved_tensors
        grads = project_shade_bwd(*inputs, radii, v_means2d, v_depths, v_conics, v_op, v_feats,
                                  *ctx.settings)
        return grads + (None, None, None)


def project_shade_grad(
    means: torch.Tensor,  # [N, 3] float32
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    coeffs: Optional[torch.Tensor],  # [N, K, 3] SH coefficients, or None
    viewmats: torch.Tensor,  # [C, 4, 4] float32, no gradient
    Ks: torch.Tensor,  # [C, 3, 3] float32, no gradient
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    antialiased: bool = False,
):
    """`project_shade`'s outputs, differentiable with respect to the float32
    means, quats, scales, opacities and coeffs: the training route.  On
    CUDA tensors, one forward and one backward kernel; on CPU tensors, the
    plain version under autograd."""
    fields = (means, quats, scales, opacities, coeffs)
    if any(t is not None and t.dtype != torch.float32 for t in fields):
        raise ValueError("project_shade_grad takes float32 gaussians")
    if viewmats.requires_grad or Ks.requires_grad:
        raise ValueError("project_shade_grad gives no gradient to viewmats or Ks")
    if not check_kernel_device("project_shade_grad", *fields, viewmats, Ks):
        return project_shade_plain(means, quats, scales, opacities, coeffs, viewmats, Ks, width,
                                   height, sh_degree, eps2d, near_plane, far_plane, radius_clip,
                                   antialiased)
    settings = (width, height, sh_degree, eps2d, near_plane, far_plane, radius_clip, antialiased)
    return _ProjectShade.apply(means, quats, scales, opacities, coeffs, viewmats, Ks, settings)
