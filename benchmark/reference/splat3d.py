"""Plain PyTorch reference of 3D Gaussian splatting: projection, SH colours,
tile binning and the front-to-back composite, forward and backward.

It follows the published gsplat semantics, which the program states as its
own contract:

  * EWA projection of each gaussian (pinhole), with the 0.3 tan(fov) clamp
    of the Jacobian, the 0.3 pixel blur on the 2D covariance, and the
    opacity-aware extent sqrt(2 ln(255 opacity)) (at most 3.33 sigma) for
    the pixel radius; culled where the depth is outside [near, far], the
    opacity is under 1/255, both radii are at most `radius_clip`, or the
    ellipse's box misses the image;
  * colours from real SH of the view direction, plus 0.5, clamped at 0;
  * per pixel (sampled at its centre), the gaussians of its 16x16 tile in
    depth order: sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, alpha =
    min(0.99, opacity exp(-sigma)), skipped where sigma < 0 or alpha < 1/255;
    a gaussian contributes while the transmittance after it stays above
    1e-4 (the first one that would take it to 1e-4 or below stops the pixel
    and is left out); colour = sum c alpha T, alpha = 1 - T_final.

It imports nothing of the program.  The binning takes every tile that the
ellipse's bounding box touches: a superset of the tiles any exact plan
keeps, since alpha is under 1/255 outside that box.  Everything is float32;
matrix products are written elementwise, so TF32 never applies.

`payload` rounds the per-slot fields (tile-local means, conic, opacity,
colours) as a composite's payload would be stored, and the per-slot
gradients on the way back: None for float32, or (forward dtype, backward
dtype), such as the control's float8 pair.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
MAX_ALPHA = 0.99
TRANSMITTANCE_THRESHOLD = 1e-4
GAUSSIAN_EXTEND = 3.33
EPS2D = 0.3
TILE = 16
SH_C0 = 0.28209479177387814
# (pixel, slot) pairs one composite chunk holds: each float32 quantity of a
# chunk then takes 128 MiB
CHUNK_PAIRS = 1 << 25


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions [N, 4] (any norm) -> rotations [N, 3, 3]."""
    q = q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def camera_center(viewmat: torch.Tensor) -> torch.Tensor:
    """-R^T t of a world-to-camera matrix [4, 4]."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    return -(R * t[:, None]).sum(0)


class Projected(NamedTuple):
    radii: torch.Tensor  # [N, 2] float (0 where culled)
    means2d: torch.Tensor  # [N, 2]
    depths: torch.Tensor  # [N]
    conics: torch.Tensor  # [N, 3]
    visible: torch.Tensor  # [N] bool


def project(means, quats, scales, opacities, viewmat, K, width: int, height: int,
            near: float, far: float, radius_clip: float) -> Projected:
    """EWA projection of N gaussians into one pinhole camera."""
    R = quat_to_rotmat(quats)
    M = R * scales[:, None, :]  # R S
    Sw = (M[:, :, None, :] * M[:, None, :, :]).sum(-1)  # (R S)(R S)^T [N, 3, 3]
    Rc, t = viewmat[:3, :3], viewmat[:3, 3]
    pc = (Rc[None] * means[:, None, :]).sum(-1) + t  # [N, 3]
    RS = (Rc[None, :, :, None] * Sw[:, None, :, :]).sum(2)  # Rc Sw  [N, 3, 3]
    Sc = (RS[:, :, None, :] * Rc[None, None, :, :]).sum(-1)  # Rc Sw Rc^T
    tx, ty, tz = pc.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tan_x, tan_y = 0.5 * width / fx, 0.5 * height / fy
    tz_safe = torch.where(tz.abs() < 1e-6, torch.ones_like(tz), tz)
    txc = tz_safe * torch.clamp(tx / tz_safe, -(cx / fx + 0.3 * tan_x),
                                (width - cx) / fx + 0.3 * tan_x)
    tyc = tz_safe * torch.clamp(ty / tz_safe, -(cy / fy + 0.3 * tan_y),
                                (height - cy) / fy + 0.3 * tan_y)
    rz = 1.0 / tz_safe
    j00, j02 = fx * rz, -fx * txc * rz * rz
    j11, j12 = fy * rz, -fy * tyc * rz * rz
    s00, s01, s02 = Sc[:, 0, 0], Sc[:, 0, 1], Sc[:, 0, 2]
    s11, s12, s22 = Sc[:, 1, 1], Sc[:, 1, 2], Sc[:, 2, 2]
    c00 = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    c01 = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c11 = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    b00, b11 = c00 + EPS2D, c11 + EPS2D
    det = torch.clamp(b00 * b11 - c01 * c01, min=1e-10)
    conics = torch.stack([b11 / det, -c01 / det, b00 / det], -1)
    means2d = torch.stack([fx * tx * rz + cx, fy * ty * rz + cy], -1)
    with torch.no_grad():
        op = opacities.detach()
        extend = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(op, min=ALPHA_THRESHOLD)
                                                        / ALPHA_THRESHOLD)), max=GAUSSIAN_EXTEND)
        rx = torch.ceil(extend * torch.sqrt(torch.clamp(b00.detach(), min=0.0)))
        ry = torch.ceil(extend * torch.sqrt(torch.clamp(b11.detach(), min=0.0)))
        mx, my = means2d.detach().unbind(-1)
        vis = (tz >= near) & (tz <= far) & (op >= ALPHA_THRESHOLD)
        vis &= ~((rx <= radius_clip) & (ry <= radius_clip))
        vis &= ~((mx + rx <= 0) | (mx - rx >= width) | (my + ry <= 0) | (my - ry >= height))
        radii = torch.where(vis[:, None], torch.stack([rx, ry], -1), 0.0)
    return Projected(radii, means2d, tz, conics, vis)


def sh_bases(dirs: torch.Tensor) -> torch.Tensor:
    """The 16 real SH bases of degree 3 at unit directions [N, 3]."""
    x, y, z = dirs.unbind(-1)
    z2 = z * z
    fC1, fS1 = x * x - y * y, 2.0 * x * y
    fC2, fS2 = x * fC1 - y * fS1, x * fS1 + y * fC1
    fTmpC = -2.285228997322329 * z2 + 0.4570457994644658
    return torch.stack([
        torch.full_like(x, SH_C0),
        -0.48860251190292 * y, 0.48860251190292 * z, -0.48860251190292 * x,
        0.5462742152960395 * fS1, -1.092548430592079 * z * y,
        0.9461746957575601 * z2 - 0.3153915652525201, -1.092548430592079 * z * x,
        0.5462742152960395 * fC1,
        -0.5900435899266435 * fS2, 1.445305721320277 * z * fS1, fTmpC * y,
        z * (1.865881662950577 * z2 - 1.119528997770346), fTmpC * x,
        1.445305721320277 * z * fC1, -0.5900435899266435 * fC2,
    ], -1)


def sh_colors(means, coeffs, viewmat, degree: int) -> torch.Tensor:
    """Colours [N, 3] of SH coefficients [N, K, 3] seen from the camera,
    plus 0.5 and clamped at 0, using the first (degree + 1)^2 bases."""
    d = means - camera_center(viewmat)
    d = d / torch.clamp(torch.sqrt((d * d).sum(-1, keepdim=True)), min=1e-12)
    nb = (degree + 1) ** 2
    rgb = (sh_bases(d)[:, :nb, None] * coeffs[:, :nb, :]).sum(1)
    return torch.clamp(rgb + 0.5, min=0.0)


class Bins(NamedTuple):
    """The depth-sorted pairs of each tile: tile t's gaussians (indices into
    the visible rows) are ids[start[t] : start[t] + count[t]]."""
    ids: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    tiles_w: int
    tiles_h: int


def bin_tiles(means2d, radii, depths, width: int, height: int) -> Bins:
    """Every (tile, gaussian) pair of the rows given (all visible): each
    tile whose span the box [mean - r, mean + r] touches."""
    tw, th = -(-width // TILE), -(-height // TILE)
    m, r = means2d.detach(), radii
    lo = torch.floor((m - r) / TILE).long()
    hi = torch.floor((m + r) / TILE).long()
    x0, y0 = torch.clamp(lo[:, 0], 0, tw - 1), torch.clamp(lo[:, 1], 0, th - 1)
    nx = torch.clamp(hi[:, 0], 0, tw - 1) - x0 + 1
    ny = torch.clamp(hi[:, 1], 0, th - 1) - y0 + 1
    return bins_of_rects(x0, y0, nx, ny, depths, tw, th)


def bins_of_rects(x0, y0, nx, ny, depths, tw: int, th: int) -> Bins:
    """The pairs of each row's rectangle of tiles (x0, y0, nx by ny), each
    tile's pairs in depth order (ties in row order)."""
    dev = x0.device
    per = nx * ny
    g = torch.repeat_interleave(torch.arange(len(per), device=dev), per)
    first = torch.cumsum(per, 0) - per
    k = torch.arange(len(g), device=dev) - first[g]
    tile = (y0[g] + k // nx[g]) * tw + x0[g] + k % nx[g]
    o = torch.argsort(depths.detach()[g], stable=True)
    o = o[torch.argsort(tile[o], stable=True)]
    count = torch.bincount(tile, minlength=tw * th)
    return Bins(g[o], torch.cumsum(count, 0) - count, count, tw, th)


class _Round(torch.autograd.Function):
    """Rounds to the payload's dtype on the way in and the per-slot
    gradient to the gradient's dtype on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _cast(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.bwd), None, None


def _cast(x, dtype):
    if dtype is None:
        return x
    big = torch.finfo(dtype).max
    return torch.clamp(x, -big, big).to(dtype).to(torch.float32)


def _chunks(bins: Bins, budget: int):
    """Tiles in groups of about `budget` padded (pixel, slot) pairs, longest
    spans first: (tile ids, longest span)."""
    order = torch.argsort(bins.count, descending=True)
    counts = bins.count[order].tolist()
    i, n = 0, len(counts)
    while i < n and counts[i] > 0:
        L = counts[i]
        nt = max(1, budget // (TILE * TILE * L))
        j = min(n, i + nt)
        while counts[j - 1] == 0:
            j -= 1
        yield order[i:j], L
        i = j


def _composite_chunk(fields, bins: Bins, tiles, L: int, width: int, height: int, payload):
    """The colours [nt, 256, 3], T_final [nt, 256], live pairs and pixel
    index [nt, 256] (-1 outside the image) of one chunk of tiles."""
    dev = fields.device
    start, count = bins.start[tiles], bins.count[tiles]
    slot = torch.arange(L, device=dev)
    real = slot[None, :] < count[:, None]  # [nt, L]
    ids = bins.ids[torch.clamp(start[:, None] + slot[None, :], max=len(bins.ids) - 1)]
    f = fields[ids]  # [nt, L, 9]
    tx = (tiles % bins.tiles_w).to(torch.float32) * TILE
    ty = (tiles // bins.tiles_w).to(torch.float32) * TILE
    local = torch.stack([f[..., 0] - tx[:, None], f[..., 1] - ty[:, None]], -1)
    f = torch.cat([local, f[..., 2:]], -1)
    if payload is not None:
        f = _Round.apply(f, *payload)
    px = torch.arange(TILE * TILE, device=dev)
    pcx = (px % TILE).to(torch.float32) + 0.5  # [256], tile-local pixel centres
    pcy = (px // TILE).to(torch.float32) + 0.5
    dx = pcx[None, :, None] - f[:, None, :, 0]  # [nt, 256, L]
    dy = pcy[None, :, None] - f[:, None, :, 1]
    a, b, c = f[:, None, :, 2], f[:, None, :, 3], f[:, None, :, 4]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    # exp of a clamped sigma: a negative one (gated below) would overflow,
    # and an infinite forward value turns the gate's zero gradient into NaN
    alpha = torch.clamp(f[:, None, :, 5] * torch.exp(-torch.clamp(sigma, min=0.0)), max=MAX_ALPHA)
    ok = (sigma >= 0) & (alpha >= ALPHA_THRESHOLD) & real[:, None, :]
    alpha = torch.where(ok, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - alpha, -1)
    live = t_incl > TRANSMITTANCE_THRESHOLD
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    w = alpha * t_excl * live
    rgb = torch.stack([(w * f[:, None, :, 6 + ch]).sum(-1) for ch in range(3)], -1)
    t_final = torch.where(live, t_incl, 1.0).amin(-1)
    gx = tx[:, None].long() + (px % TILE)[None, :]
    gy = ty[:, None].long() + (px // TILE)[None, :]
    pix = torch.where((gx < width) & (gy < height), gy * width + gx, -1)
    n_live = int((ok & live & (pix >= 0)[:, :, None]).sum())
    return rgb, t_final, n_live, pix


def composite(fields, bins: Bins, width: int, height: int, payload=None,
              budget: int = CHUNK_PAIRS):
    """Forward: (image [H, W, 3], alpha [H, W], live pairs).  `fields` are
    the visible rows' [V, 9] (x, y, conic a, b, c, opacity, r, g, b)."""
    dev = fields.device
    img = torch.zeros(height * width, 3, device=dev)
    tf = torch.ones(height * width, device=dev)
    n_live = 0
    with torch.no_grad():
        for tiles, L in _chunks(bins, budget):
            rgb, t_final, n, pix = _composite_chunk(fields, bins, tiles, L, width, height,
                                                    payload)
            inside = pix >= 0
            img[pix[inside]] = rgb[inside]
            tf[pix[inside]] = t_final[inside]
            n_live += n
    return img.reshape(height, width, 3), (1.0 - tf).reshape(height, width), n_live


def composite_backward(fields, bins: Bins, width: int, height: int, v_img: torch.Tensor,
                       payload=None, budget: int = CHUNK_PAIRS // 2) -> torch.Tensor:
    """The gradient of sum(image * v_img) with respect to `fields` [V, 9],
    chunk by chunk (each chunk's forward again, with autograd)."""
    leaf = fields.detach().requires_grad_()
    v = v_img.reshape(-1, 3)
    for tiles, L in _chunks(bins, budget):
        rgb, _, _, pix = _composite_chunk(leaf, bins, tiles, L, width, height, payload)
        inside = (pix >= 0)[..., None]
        (rgb * torch.where(inside, v[torch.clamp(pix, min=0)], 0.0)).sum().backward()
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


class View(NamedTuple):
    """What one camera sees of a scene: the projection with its autograd
    graph, the visible rows' fields and their bins."""
    proj: Projected
    fields: torch.Tensor  # [V, 9], with the graph back to the parameters
    bins: Bins


def view(params: Dict[str, torch.Tensor], viewmat, K, width: int, height: int,
         render: Dict[str, float], sh_degree: int, alive: Optional[torch.Tensor] = None) -> View:
    """Project raw parameters (log scales, logit opacities, SH) into one
    camera; `render` holds near, far and radius_clip."""
    op = torch.sigmoid(params["opacities"])
    if alive is not None:
        op = torch.where(alive, op, 0.0)
    p = project(params["means"], params["quats"], torch.exp(params["scales"]), op, viewmat, K,
                width, height, render["near_plane"], render["far_plane"],
                render["radius_clip"])
    coeffs = torch.cat([params["sh0"], params["shN"]], 1)
    rows = torch.nonzero(p.visible)[:, 0]
    cols = sh_colors(params["means"][rows], coeffs[rows], viewmat, sh_degree)
    fields = torch.cat([p.means2d[rows], p.conics[rows], op[rows, None], cols], -1)
    bins = bin_tiles(p.means2d[rows], p.radii[rows], p.depths[rows], width, height)
    return View(p, fields, bins)


def render(params, viewmat, K, width: int, height: int, render_kw, sh_degree: int,
           payload=None) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(image, alpha, live pairs, visible gaussians) without autograd."""
    with torch.no_grad():
        v = view(params, viewmat, K, width, height, render_kw, sh_degree)
        img, alpha, n_live = composite(v.fields, v.bins, width, height, payload)
    return img, alpha, n_live, int(v.proj.visible.sum())

