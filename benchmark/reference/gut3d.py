"""Plain PyTorch reference of 3DGUT (Wu et al., "3DGUT: Enabling Distorted
Cameras and Secondary Rays in Gaussian Splatting", CVPR 2025,
arXiv:2412.12507) as upstream gsplat runs it with `with_ut` and
`with_eval3d`: the unscented projection through an OpenCV radial pinhole
for tiling and sorting, each pixel's world-space ray through the same
camera, and the composite that evaluates every gaussian along the ray.

  * Unscented transform (Wan and van der Merwe 2000; alpha 0.1, beta 2,
    kappa 0, lambda = alpha^2 (3 + kappa) - 3): the mean and the six points
    mean +/- sqrt(3 + lambda) s_i R[:, i] go through the camera; the 2D mean
    and covariance are their weighted sums (mean weights lambda / (3 +
    lambda) for the centre, 1 / (2 (3 + lambda)) for the others; the
    covariance's centre weight adds 1 - alpha^2 + beta).  A sigma point is
    valid in front of the camera (z > 0), where the radial factor is above
    0.8, and inside the image widened by a tenth of its size on each side; a
    gaussian needs one valid point, and every point enters the sums.
  * The camera: p_c = R p + t, (x, y) = p_c.xy / z, r^2 = x^2 + y^2,
    pixel = (1 + k1 r^2 + k2 r^4 + k3 r^6) (x, y) f + c.
  * Culling and radii as upstream's UT projection: the centre's depth in
    [near, far], the covariance plus 0.3 I with a positive determinant and
    diagonal, opacity times the blur's compensation at least 1/255, the
    opacity-aware extent min(3.33, sqrt(2 ln(255 opacity'))), the radius per
    axis ceil(min(extent sqrt(cov_ii), extent sqrt(larger eigenvalue))) with
    the eigenvalue's discriminant floored at 0.01, above `radius_clip`, and
    the box [mean - r, mean + r] overlapping the image.
  * Tiles (16 x 16): x from floor((mx - rx) / 16) to ceil((mx + rx) / 16),
    end excluded, clamped to the image; each tile's gaussians in order of
    the centre's camera depth.  The projection only tiles and sorts: the
    tile set is part of the function, as in the program, since the 3D
    response does not vanish at the projected box's edge.
  * Rays: the pixel centre (x + 0.5, y + 0.5) undistorted by Newton's
    method on the radius alone (the model is radial: the undistorted point
    lies on the same ray from the principal point), normalised, rotated to
    the world; the origin is the camera centre.
  * Per (pixel, gaussian): M = diag(1/s) R^T, u = M d, g = M (o - x),
    u^ = u / |u|, the squared distance of the whitened ray from the centre
    |u^ x g|^2, alpha = min(0.99, opacity exp(-|u^ x g|^2 / 2)); the pair is
    skipped where alpha < 1/255 or the point of largest response lies
    behind the origin (-u^ . g < 0).  Front to back, a gaussian contributes
    while the transmittance after it stays above 1e-4 (the first one that
    would take it to 1e-4 or below stops the pixel and is left out); colour
    = sum c alpha T, alpha = 1 - T_final.

It imports nothing of the program.  Everything is float32 and elementwise,
so TF32 never applies, with two departures, each more exact than float32
alone: the UT's weighted sums are taken in float64 and rounded once (the
centre weight is -99, so float32 rounding of a 2000-pixel mean would show
a hundred times over), and the rays are undistorted in float64 and rounded
once.  `payload` rounds the per-slot fields and gradients as in
splat3d.composite.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .splat3d import (ALPHA_THRESHOLD, CHUNK_PAIRS, GAUSSIAN_EXTEND, MAX_ALPHA, TILE,
                      TRANSMITTANCE_THRESHOLD, Bins, _chunks, _Round, bins_of_rects,
                      camera_center, quat_to_rotmat, sh_colors)

UT_ALPHA, UT_BETA, UT_KAPPA = 0.1, 2.0, 0.0
IN_IMAGE_MARGIN = 0.1
MIN_RADIAL_FACTOR = 0.8
EPS2D = 0.3
MIN_COMPENSATION = 0.005
EIGEN_FLOOR = 0.01
NEWTON_STEPS = 12  # the radial inverse converges in 4 or 5 at the configured lens
FIELDS = 3 + 9 + 1 + 3  # x, M row-major, opacity, rgb


def ut_weights() -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean weights [7], covariance weights [7], sqrt(3 + lambda)), float64."""
    lam = UT_ALPHA ** 2 * (3.0 + UT_KAPPA) - 3.0
    w0 = lam / (3.0 + lam)
    wi = 1.0 / (2.0 * (3.0 + lam))
    wm = torch.tensor([w0] + [wi] * 6, dtype=torch.float64)
    wc = torch.tensor([w0 + 1.0 - UT_ALPHA ** 2 + UT_BETA] + [wi] * 6, dtype=torch.float64)
    return wm, wc, math.sqrt(3.0 + lam)


def distort_factor(r2: torch.Tensor, radial: Sequence[float]) -> torch.Tensor:
    """1 + k1 r^2 + k2 r^4 + k3 r^6 (+ ...: k1..k6 as the OpenCV numerator,
    whose denominator is 1 here; k4..k6 must be zero)."""
    if any(radial[3:]):
        raise ValueError("the reference takes k1..k3; k4..k6 (the rational model) must be 0")
    k = list(radial[:3]) + [0.0] * (3 - len(radial[:3]))
    return 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))


def camera_points(points: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
                  radial: Sequence[float], width: int, height: int):
    """World points [..., 3] -> (pixels [..., 2], valid [...], camera z [...])."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    pc = (R * points[..., None, :]).sum(-1) + t
    z = pc[..., 2]
    xy = pc[..., :2] / z[..., None]
    factor = distort_factor((xy * xy).sum(-1), radial)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    pix = factor[..., None] * xy * f + c
    mx, my = IN_IMAGE_MARGIN * width, IN_IMAGE_MARGIN * height
    u, v = pix[..., 0], pix[..., 1]
    inside = (u >= -mx) & (u < width + mx) & (v >= -my) & (v < height + my)
    return pix, (z > 0) & (factor > MIN_RADIAL_FACTOR) & inside, z


class Projected(NamedTuple):
    radii: torch.Tensor  # [N, 2] float (0 where culled)
    means2d: torch.Tensor  # [N, 2]
    depths: torch.Tensor  # [N] the centre's camera z
    visible: torch.Tensor  # [N] bool


@torch.no_grad()
def ut_project(means, quats, scales, opacities, viewmat, K, radial: Sequence[float],
               width: int, height: int, near: float, far: float,
               radius_clip: float) -> Projected:
    """The unscented projection of N gaussians (tiling and sorting only: no
    gradient flows through it)."""
    wm, wc, spread = ut_weights()
    R = quat_to_rotmat(quats)
    deltas = (spread * R * scales[:, None, :]).transpose(1, 2)  # [N, 3 axes, 3]
    m = means[:, None, :]
    sigma = torch.cat([m, m + deltas, m - deltas], 1)  # [N, 7, 3]
    pix, ok, _ = camera_points(sigma, viewmat, K, radial, width, height)
    depth = camera_points(means, viewmat, K, radial, width, height)[2]
    p64 = pix.double()
    mean = (wm[None, :, None].to(p64.device) * p64).sum(1)
    d = p64 - mean[:, None, :]
    cov = (wc[None, :, None, None].to(p64.device) * d[..., :, None] * d[..., None, :]).sum(1)
    mean, cov = mean.float(), cov.float()
    det0 = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] * cov[:, 1, 0]
    c00, c01, c11 = cov[:, 0, 0] + EPS2D, cov[:, 0, 1], cov[:, 1, 1] + EPS2D
    det = c00 * c11 - c01 * c01
    comp = torch.sqrt(torch.clamp(det0 / det, min=MIN_COMPENSATION ** 2))
    op = opacities * comp
    eps = torch.finfo(torch.float32).eps
    vis = ok.any(1) & (depth >= near) & (depth <= far)
    vis &= ((quats * quats).sum(-1) > eps) & (scales > eps).all(-1)
    vis &= (det > 0) & (c00 > 0) & (c11 > 0) & (op >= ALPHA_THRESHOLD)
    extend = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(op / ALPHA_THRESHOLD, min=1.0))),
                         max=GAUSSIAN_EXTEND)
    b = 0.5 * (c00 + c11)
    big = b + torch.sqrt(torch.clamp(b * b - det, min=EIGEN_FLOOR))
    r_eig = extend * torch.sqrt(torch.clamp(big, min=0.0))
    diag = torch.stack([c00, c11], -1)
    radius = torch.ceil(torch.minimum(extend[:, None] * torch.sqrt(torch.clamp(diag, min=0.0)),
                                      r_eig[:, None]))
    vis &= radius.amax(-1) > radius_clip
    size = torch.tensor([width, height], dtype=torch.float32, device=means.device)
    vis &= ((mean + radius > 0) & (mean - radius < size)).all(-1)
    radii = torch.where(vis[:, None], radius, 0.0)
    return Projected(radii, mean, depth, vis)


def bin_tiles(means2d, radii, depths, width: int, height: int) -> Bins:
    """The tiles of each row's box (the rows given are visible)."""
    tw, th = -(-width // TILE), -(-height // TILE)
    lo = torch.floor((means2d - radii) / TILE).long()
    hi = torch.ceil((means2d + radii) / TILE).long()
    x0, y0 = torch.clamp(lo[:, 0], 0, tw), torch.clamp(lo[:, 1], 0, th)
    nx = torch.clamp(hi[:, 0], 0, tw) - x0
    ny = torch.clamp(hi[:, 1], 0, th) - y0
    return bins_of_rects(torch.clamp(x0, max=tw - 1), torch.clamp(y0, max=th - 1), nx, ny,
                         depths, tw, th)


@torch.no_grad()
def camera_rays(viewmat, K, radial: Sequence[float], width: int, height: int) -> torch.Tensor:
    """World rays [H * W, 6] (origin, unit direction) through every pixel
    centre.  Newton on r (1 + k1 r^2 + k2 r^4 + k3 r^6) = r_d, from r_d."""
    dev = viewmat.device
    K64, vm64 = K.double(), viewmat.double()
    px = torch.arange(width, dtype=torch.float64, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float64, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    xd = ((gx - K64[0, 2]) / K64[0, 0]).reshape(-1)
    yd = ((gy - K64[1, 2]) / K64[1, 1]).reshape(-1)
    rd = torch.sqrt(xd * xd + yd * yd)
    k = list(radial[:3]) + [0.0] * (3 - len(radial[:3]))
    r = rd.clone()
    for _ in range(NEWTON_STEPS):
        r2 = r * r
        f = r * (1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))) - rd
        df = 1.0 + r2 * (3.0 * k[0] + r2 * (5.0 * k[1] + r2 * 7.0 * k[2]))
        r = r - f / df
    scale = torch.where(rd > 0, r / torch.clamp(rd, min=1e-300), 1.0)
    d_cam = torch.stack([xd * scale, yd * scale, torch.ones_like(xd)], -1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    R = vm64[:3, :3]
    d_world = (R.t()[None] * d_cam[:, None, :]).sum(-1)  # R^T d
    origin = camera_center(vm64).expand_as(d_world)
    return torch.cat([origin, d_world], -1).float()


def _composite_chunk(fields, bins: Bins, tiles, L: int, rays, width: int, height: int, payload):
    """Colours [nt, 256, 3], T_final [nt, 256], live pairs and pixel index
    [nt, 256] (-1 outside the image) of one chunk of tiles."""
    dev = fields.device
    start, count = bins.start[tiles], bins.count[tiles]
    slot = torch.arange(L, device=dev)
    real = slot[None, :] < count[:, None]  # [nt, L]
    ids = bins.ids[torch.clamp(start[:, None] + slot[None, :], max=len(bins.ids) - 1)]
    f = fields[ids]  # [nt, L, 16]
    if payload is not None:
        f = _Round.apply(f, *payload)
    px = torch.arange(TILE * TILE, device=dev)
    gx = (tiles % bins.tiles_w)[:, None] * TILE + (px % TILE)[None, :]
    gy = (tiles // bins.tiles_w)[:, None] * TILE + (px // TILE)[None, :]
    pix = torch.where((gx < width) & (gy < height), gy * width + gx, -1)  # [nt, 256]
    ray = torch.where((pix >= 0)[..., None], rays[torch.clamp(pix, min=0)], 0.0)
    o, d = ray[:, :, None, 0:3], ray[:, :, None, 3:6]  # [nt, 256, 1, 3]
    ox = o - f[:, None, :, 0:3]  # [nt, 256, L, 3]

    def times_M(v):  # M v, a row of M at a time: [nt, 256, L, 3]
        return torch.stack([sum(f[:, None, :, 3 + 3 * k + i] * v[..., i] for i in range(3))
                            for k in range(3)], -1)

    u, g = times_M(d), times_M(ox)
    uh = u / torch.sqrt(torch.clamp((u * u).sum(-1, keepdim=True), min=1e-24))
    c = torch.linalg.cross(uh, g, dim=-1)
    gray = (c * c).sum(-1)
    hit = -(uh * g).sum(-1)
    # exp of a non-negative argument: no overflow whatever the pair
    alpha = torch.clamp(f[:, None, :, 12] * torch.exp(-0.5 * gray), max=MAX_ALPHA)
    ok = (hit >= 0) & (alpha >= ALPHA_THRESHOLD) & real[:, None, :] & (pix >= 0)[..., None]
    alpha = torch.where(ok, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - alpha, -1)
    live = t_incl > TRANSMITTANCE_THRESHOLD
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    w = alpha * t_excl * live
    rgb = torch.stack([(w * f[:, None, :, 13 + ch]).sum(-1) for ch in range(3)], -1)
    t_final = torch.where(live, t_incl, 1.0).amin(-1)
    n_live = int((ok & live).sum())
    return rgb, t_final, n_live, pix


def composite(fields, bins: Bins, rays, width: int, height: int, payload=None,
              budget: int = CHUNK_PAIRS // 2):
    """Forward: (image [H, W, 3], alpha [H, W], live pairs).  `fields` are the
    visible rows' [V, 16] (x, M, opacity, rgb); `rays` [H * W, 6]."""
    dev = fields.device
    img = torch.zeros(height * width, 3, device=dev)
    tf = torch.ones(height * width, device=dev)
    n_live = 0
    with torch.no_grad():
        for tiles, L in _chunks(bins, budget):
            rgb, t_final, n, pix = _composite_chunk(fields, bins, tiles, L, rays, width, height,
                                                    payload)
            inside = pix >= 0
            img[pix[inside]] = rgb[inside]
            tf[pix[inside]] = t_final[inside]
            n_live += n
    return img.reshape(height, width, 3), (1.0 - tf).reshape(height, width), n_live


def composite_backward(fields, bins: Bins, rays, width: int, height: int, v_img: torch.Tensor,
                       payload=None, budget: int = CHUNK_PAIRS // 8) -> torch.Tensor:
    """The gradient of sum(image * v_img) with respect to `fields` [V, 16],
    chunk by chunk (each chunk's forward again, with autograd)."""
    leaf = fields.detach().requires_grad_()
    v = v_img.reshape(-1, 3)
    for tiles, L in _chunks(bins, budget):
        rgb, _, _, pix = _composite_chunk(leaf, bins, tiles, L, rays, width, height, payload)
        inside = (pix >= 0)[..., None]
        (rgb * torch.where(inside, v[torch.clamp(pix, min=0)], 0.0)).sum().backward()
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


class View(NamedTuple):
    """What one camera sees: the projection, the visible rows' fields (with
    the autograd graph back to the parameters), their bins and the rays."""
    proj: Projected
    fields: torch.Tensor
    bins: Bins
    rays: torch.Tensor


def view(params: Dict[str, torch.Tensor], viewmat, K, radial: Sequence[float], width: int,
         height: int, render: Dict[str, float], sh_degree: int,
         alive: Optional[torch.Tensor] = None) -> View:
    """Project raw parameters (log scales, logit opacities, SH) into one
    distorting camera; `render` holds near, far and radius_clip."""
    op = torch.sigmoid(params["opacities"])
    if alive is not None:
        op = torch.where(alive, op, 0.0)
    scales = torch.exp(params["scales"])
    p = ut_project(params["means"].detach(), params["quats"].detach(), scales.detach(),
                   op.detach(), viewmat, K, radial, width, height, render["near_plane"],
                   render["far_plane"], render["radius_clip"])
    rows = torch.nonzero(p.visible)[:, 0]
    bins = bin_tiles(p.means2d[rows], p.radii[rows], p.depths[rows], width, height)
    coeffs = torch.cat([params["sh0"], params["shN"]], 1)
    cols = sh_colors(params["means"][rows], coeffs[rows], viewmat, sh_degree)
    R = quat_to_rotmat(params["quats"][rows])
    M = R.transpose(1, 2) / scales[rows][:, :, None]  # diag(1/s) R^T
    fields = torch.cat([params["means"][rows], M.reshape(-1, 9), op[rows, None], cols], -1)
    return View(p, fields, bins, camera_rays(viewmat, K, radial, width, height))


def render(params, viewmat, K, radial: Sequence[float], width: int, height: int, render_kw,
           sh_degree: int, payload=None) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(image, alpha, live pairs, visible gaussians) without autograd."""
    with torch.no_grad():
        v = view(params, viewmat, K, radial, width, height, render_kw, sh_degree)
        img, alpha, n_live = composite(v.fields, v.bins, v.rays, width, height, payload)
    return img, alpha, n_live, int(v.proj.visible.sum())
