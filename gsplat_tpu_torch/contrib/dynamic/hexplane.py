"""HexPlane field: a multi-resolution 6-plane decomposition of a 4D field.

Port of `gsplat_tpu/contrib/dynamic/hexplane.py`: per scale, six 2D feature
planes over every pair of the (x, y, z, t) axes are sampled bilinearly and
multiplied elementwise; the scales are concatenated.  Planes over a pair
holding the time axis start at ones, spatial pairs at U(0.1, 0.5) (drawn
from a `torch.Generator` where the JAX package splits a key; tests carry
the JAX draws across with `scene.convert.hexplane_from_numpy`).  Spatial
coordinates are normalised to [-1, 1] over the AABB; time passes through.
Sampling clamps out-of-range coordinates (grid_sample's
padding_mode="border", align_corners=True).

A functional module, as the JAX one: `hexplane_init(...)` returns the
parameter dict and `hexplane_apply(params, xyzt)` evaluates it.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch

from ..._device import DeviceLike, resolve_device

DEFAULT_PLANE_CONFIG = {
    "grid_dimensions": 2,
    "input_coordinate_dim": 4,
    "output_coordinate_dim": 32,
    "resolution": [64, 64, 64, 25],
}
DEFAULT_MULTIRES = (1, 2)

SPATIAL_PLANE_IDXS = (0, 1, 3)  # xy, xz, yz
TEMPORAL_PLANE_IDXS = (2, 4, 5)  # xt, yt, zt


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of grid [C, H, W] at coords [N, 2] in [-1, 1] -> [N, C].

    align_corners=True with border padding (F.grid_sample's), by the JAX
    function's gather formula, whose x0 stays at most W - 2 (so a sample on
    the last column is the weight-1 end of the last cell).  coords[:, 0]
    indexes W, coords[:, 1] H.
    """
    C, H, W = grid.shape
    x = torch.clamp((coords[:, 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((coords[:, 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = (torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2) if W > 1
          else torch.zeros_like(x, dtype=torch.int64))
    y0 = (torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2) if H > 1
          else torch.zeros_like(y, dtype=torch.int64))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    v00 = grid[:, y0, x0]  # [C, N]
    v01 = grid[:, y0, x1]
    v10 = grid[:, y1, x0]
    v11 = grid[:, y1, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).t()


def hexplane_init(
    generator: Optional[torch.Generator] = None,
    bounds: float = 1.6,
    planes_config: Optional[dict] = None,
    multires: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> Dict:
    """HexPlane parameters on `device` (the card unless named): {'grids':
    [scale][plane] tensors [C, H, W], 'aabb': [2, 3], 'config', 'multires',
    'feat_dim', 'coo_combs'}."""
    dev = resolve_device(device)
    config = dict(planes_config or DEFAULT_PLANE_CONFIG)
    multires = list(multires if multires is not None else DEFAULT_MULTIRES)
    in_dim = config["input_coordinate_dim"]
    out_dim = config["output_coordinate_dim"]
    coo_combs = list(itertools.combinations(range(in_dim), config["grid_dimensions"]))
    has_time = in_dim == 4

    grids: List[List[torch.Tensor]] = []
    feat_dim = 0
    for res in multires:
        base = list(config["resolution"])
        reso = [r * res for r in base[:3]] + base[3:]
        scale_planes = []
        for comb in coo_combs:
            # reversed order: [C, reso[comb[-1]], ..., reso[comb[0]]]
            shape = (out_dim,) + tuple(reso[c] for c in comb[::-1])
            if has_time and 3 in comb:
                p = torch.ones(shape, dtype=torch.float32)
            else:
                p = torch.rand(shape, generator=generator, dtype=torch.float32) * 0.4 + 0.1
            scale_planes.append(p.to(dev))
        feat_dim += out_dim
        grids.append(scale_planes)
    aabb = torch.tensor([[bounds] * 3, [-bounds] * 3], dtype=torch.float32, device=dev)
    return dict(grids=grids, aabb=aabb, config=config, multires=multires, feat_dim=feat_dim,
                coo_combs=coo_combs)


def hexplane_apply(params: Dict, xyzt: torch.Tensor) -> torch.Tensor:
    """The field at [N, 4] (x, y, z, t) points -> [N, feat_dim]."""
    if xyzt.shape[-1] != 4:
        raise ValueError(f"xyzt last dim must be 4, got {tuple(xyzt.shape)}")
    aabb = params["aabb"]
    xyz = (xyzt[..., :3] - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0
    pts = torch.cat([xyz, xyzt[..., 3:]], dim=-1).reshape(-1, 4)
    outs = []
    for scale_planes in params["grids"]:
        interp = 1.0
        for plane, comb in zip(scale_planes, params["coo_combs"]):
            # plane [C, reso[c1], reso[c0]]: the W axis is the first coordinate
            interp = interp * grid_sample_2d(plane, pts[:, list(comb)])
        outs.append(interp)
    return torch.cat(outs, dim=-1)


def spatial_planes(params: Dict) -> List[torch.Tensor]:
    """The spatial (xy, xz, yz) planes of every scale, in one list."""
    return [s[i] for s in params["grids"] for i in SPATIAL_PLANE_IDXS]


def temporal_planes(params: Dict) -> List[torch.Tensor]:
    """The spatio-temporal (xt, yt, zt) planes of every scale, in one list."""
    return [s[i] for s in params["grids"] for i in TEMPORAL_PLANE_IDXS]
