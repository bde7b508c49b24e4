"""Plain PyTorch reference of 2D Gaussian splatting (surfels): projection,
the composite with normals and distortion, forward and backward.

The 2DGS semantics (Huang et al. 2024, and gsplat's rasterization_2dgs):

  * each surfel is the z = 0 plane of its local frame (R S, the third scale
    unused); M = (K [R S_:2 | mean_c])^T maps homogeneous pixels to the
    plane's (u, v); the screen mean and extent come from the homogeneous
    quadric of M's third row, the radius is ceil(3.33 extent); culled
    where that quadric degenerates, the depth is outside (near, far), or
    the box misses the image; normals are the local z axis turned to the
    camera;
  * per pixel centre p, the gaussians of its tile (every tile the box
    [mean - r, mean + r] overlaps, tiles [floor((m - r)/16),
    ceil((m + r)/16))) in depth order: h_u = p_x M_w - M_u, h_v = p_y M_w -
    M_v, s = h_u x h_v, sigma = 0.5 min((s_x^2 + s_y^2) / s_z^2, 2 |p -
    mean|^2), skipped where s_z = 0; alpha and the stop as in 3DGS;
  * outputs: the colours with the depth as a last channel, the normals
    (camera frame, turned to the world by R^T), alpha, and the distortion
    2 sum_i w_i (d_i A_i - B_i), A and B the exclusive sums of w and w d.

It imports nothing of the program; everything is float32 and elementwise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .splat3d import (ALPHA_THRESHOLD, CHUNK_PAIRS, MAX_ALPHA, TILE, TRANSMITTANCE_THRESHOLD,
                      Bins, _chunks, _Round, bins_of_rects, quat_to_rotmat, sh_colors)

EXTEND_2D = 3.33
FILTER_INV_SQUARE = 2.0
N_FIELDS = 2 + 9 + 1 + 4 + 3  # mean, M, opacity, rgb + depth, normal
N_OUT = 4 + 3 + 1 + 1  # rgb + depth sums, normal, alpha, distortion


def _mm(A, B):
    """A @ B for [..., 3, 3], elementwise."""
    return sum(A[..., :, j:j + 1] * B[..., j:j + 1, :] for j in range(3))


class Projected(NamedTuple):
    radii: torch.Tensor  # [N, 2] float (0 where culled)
    means2d: torch.Tensor  # [N, 2]
    depths: torch.Tensor  # [N]
    M: torch.Tensor  # [N, 3, 3]: rows u, v, w
    normals: torch.Tensor  # [N, 3] camera frame
    visible: torch.Tensor  # [N] bool


def project(means, quats, scales, viewmat, K, width: int, height: int, near: float,
            far: float) -> Projected:
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    mc = (R[None] * means[:, None, :]).sum(-1) + t  # [N, 3]
    RS = quat_to_rotmat(quats) * scales[:, None, :]
    RSc = _mm(R[None], RS)
    n = RSc[..., 2]
    n = n * torch.where(-(n * mc).sum(-1, keepdim=True) > 0, 1.0, -1.0)
    T = torch.cat([RSc[..., :2], mc[..., None]], -1)  # [N, 3, 3]
    M = _mm(K[None], T).transpose(-1, -2)  # rows: u, v, w of the homogeneous pixel
    test = torch.tensor([1.0, 1.0, -1.0], device=means.device)
    d = (M[..., 2] * M[..., 2] * test).sum(-1, keepdim=True)
    ok_d = d.abs() > 1e-30
    f = torch.where(ok_d, test / torch.where(ok_d, d, 1.0), 0.0)[..., None]
    means2d = (M[..., :2] * M[..., 2:3] * f).sum(-2)
    ext = torch.sqrt(torch.clamp(means2d ** 2 - (M[..., :2] * M[..., :2] * f).sum(-2), min=1e-4))
    with torch.no_grad():
        r = torch.ceil(EXTEND_2D * ext)
        m2 = means2d.detach()
        z = mc[:, 2].detach()
        vis = (ok_d[:, 0] & (z > near) & (z < far) & (m2[:, 0] + r[:, 0] > 0)
               & (m2[:, 0] - r[:, 0] < width) & (m2[:, 1] + r[:, 1] > 0)
               & (m2[:, 1] - r[:, 1] < height))
        radii = torch.where(vis[:, None], r, 0.0)
    return Projected(radii, means2d, mc[:, 2], M.transpose(-1, -2), n, vis)


def facing(means, proj: Projected, viewmat, min_cos: float) -> torch.Tensor:
    """[N] bool: the visible surfels whose normal makes a |cosine| of at
    least `min_cos` with the ray to their centre.  Nearer edge-on, the
    composite divides by a vanishing s_z, and a surfel's gradient there
    rests on rounding."""
    with torch.no_grad():
        R, t = viewmat[:3, :3], viewmat[:3, 3]
        mc = (R[None] * means.detach()[:, None, :]).sum(-1) + t
        n = proj.normals.detach()
        norms = torch.linalg.vector_norm(n, dim=-1) * torch.linalg.vector_norm(mc, dim=-1)
        cos = (n * mc).sum(-1).abs() / torch.clamp(norms, min=1e-30)
        return proj.visible & (cos >= min_cos)


def bin_tiles(means2d, radii, depths, width: int, height: int) -> Bins:
    """Each gaussian's tiles [floor(m/16 - r/16), ceil(m/16 + r/16)),
    clipped to the image: the program's rule, since a surfel's screen
    filter can reach past its box."""
    tw, th = -(-width // TILE), -(-height // TILE)
    tm, tr = means2d.detach() / TILE, radii / TILE
    lo = torch.floor(tm - tr).long()
    hi = torch.ceil(tm + tr).long()
    x0, y0 = torch.clamp(lo[:, 0], 0, tw), torch.clamp(lo[:, 1], 0, th)
    nx = torch.clamp(torch.clamp(hi[:, 0], 0, tw) - x0, min=0)
    ny = torch.clamp(torch.clamp(hi[:, 1], 0, th) - y0, min=0)
    return bins_of_rects(x0, y0, nx, ny, depths, tw, th)


def _chunk(fields, bins: Bins, tiles, L: int, width: int, height: int, payload):
    """Per pixel of a chunk of tiles [nt, 256, N_OUT], the live pairs, and
    the pixels' flat index (-1 outside the image).  `payload` as in
    splat3d."""
    dev = fields.device
    start, count = bins.start[tiles], bins.count[tiles]
    slot = torch.arange(L, device=dev)
    real = slot[None, :] < count[:, None]
    f = fields[bins.ids[torch.clamp(start[:, None] + slot[None, :], max=len(bins.ids) - 1)]]
    if payload is not None:
        f = _Round.apply(f, *payload)
    px = torch.arange(TILE * TILE, device=dev)
    gx = (tiles % bins.tiles_w)[:, None] * TILE + (px % TILE)[None, :]  # [nt, 256]
    gy = (tiles // bins.tiles_w)[:, None] * TILE + (px // TILE)[None, :]
    x = (gx.to(torch.float32) + 0.5)[:, :, None]
    y = (gy.to(torch.float32) + 0.5)[:, :, None]
    Mt = f[:, None, :, 2:11]  # [nt, 1, L, 9]
    hu = [x * Mt[..., 6 + k] - Mt[..., k] for k in range(3)]
    hv = [y * Mt[..., 6 + k] - Mt[..., 3 + k] for k in range(3)]
    cx = hu[1] * hv[2] - hu[2] * hv[1]
    cy = hu[2] * hv[0] - hu[0] * hv[2]
    cz = hu[0] * hv[1] - hu[1] * hv[0]
    czs = torch.where(cz == 0.0, 1.0, cz)
    su, sv = cx / czs, cy / czs
    dx, dy = f[:, None, :, 0] - x, f[:, None, :, 1] - y
    sigma = 0.5 * torch.minimum(FILTER_INV_SQUARE * (dx * dx + dy * dy), su * su + sv * sv)
    alpha = torch.clamp(f[:, None, :, 11] * torch.exp(-torch.clamp(sigma, min=0.0)),
                        max=MAX_ALPHA)
    ok = (cz != 0.0) & (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & real[:, None, :]
    alpha = torch.where(ok, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - alpha, -1)
    live = t_incl > TRANSMITTANCE_THRESHOLD
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    w = alpha * t_excl * live
    chans = [(w * f[:, None, :, 12 + c]).sum(-1) for c in range(7)]  # rgb, depth, normal
    m = f[:, None, :, 15]
    A = torch.cumsum(w, -1) - w
    B = torch.cumsum(w * m, -1) - w * m
    distort = (2.0 * w * (m * A - B)).sum(-1)
    t_final = torch.where(live, t_incl, 1.0).amin(-1)
    out = torch.stack(chans + [1.0 - t_final, distort], -1)
    pix = torch.where((gx < width) & (gy < height), gy * width + gx, -1)
    n_live = int((ok & live & (pix >= 0)[:, :, None]).sum())
    return out, n_live, pix


def composite(fields, bins: Bins, width: int, height: int, payload=None,
              budget: int = CHUNK_PAIRS // 4):
    """(per-pixel outputs [H, W, N_OUT], live pairs) without autograd."""
    out = torch.zeros(height * width, N_OUT, device=fields.device)
    n_live = 0
    with torch.no_grad():
        for tiles, L in _chunks(bins, budget):
            o, n, pix = _chunk(fields, bins, tiles, L, width, height, payload)
            inside = pix >= 0
            out[pix[inside]] = o[inside]
            n_live += n
    return out.reshape(height, width, N_OUT), n_live


def composite_backward(fields, bins: Bins, width: int, height: int, v_out: torch.Tensor,
                       payload=None, budget: int = CHUNK_PAIRS // 8) -> torch.Tensor:
    leaf = fields.detach().requires_grad_()
    v = v_out.reshape(-1, N_OUT)
    for tiles, L in _chunks(bins, budget):
        o, _, pix = _chunk(leaf, bins, tiles, L, width, height, payload)
        inside = (pix >= 0)[..., None]
        (o * torch.where(inside, v[torch.clamp(pix, min=0)], 0.0)).sum().backward()
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


class View(NamedTuple):
    proj: Projected
    fields: torch.Tensor  # [V, N_FIELDS] with the graph back to the parameters
    bins: Bins


def view(params: Dict[str, torch.Tensor], viewmat, K, width: int, height: int,
         render: Dict[str, float], sh_degree: int) -> View:
    p = project(params["means"], params["quats"], torch.exp(params["scales"]), viewmat, K,
                width, height, render["near_plane"], render["far_plane"])
    rows = torch.nonzero(p.visible)[:, 0]
    coeffs = torch.cat([params["sh0"], params["shN"]], 1)
    cols = sh_colors(params["means"][rows], coeffs[rows], viewmat, sh_degree)
    op = torch.sigmoid(params["opacities"][rows])
    fields = torch.cat([p.means2d[rows], p.M[rows].reshape(-1, 9), op[:, None], cols,
                        p.depths[rows, None], p.normals[rows]], -1)
    return View(p, fields, bin_tiles(p.means2d[rows], p.radii[rows], p.depths[rows], width,
                                     height))


def depth_to_normal(depth: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Normals [H, W, 3] of a z-depth map [H, W] by the cross product of
    the neighbours' world points; zero on the 1-pixel border."""
    H, W = depth.shape
    c2w = torch.linalg.inv(viewmat)
    x = torch.arange(W, device=depth.device, dtype=torch.float32)
    y = torch.arange(H, device=depth.device, dtype=torch.float32)
    dx = ((x[None, :] - K[0, 2] + 0.5) / K[0, 0]).expand(H, W)
    dy = ((y[:, None] - K[1, 2] + 0.5) / K[1, 1]).expand(H, W)
    dirs = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    pts = c2w[:3, 3] + depth[..., None] * (c2w[:3, :3] * dirs[..., None, :]).sum(-1)
    ddx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    ddy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(ddx, ddy, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
