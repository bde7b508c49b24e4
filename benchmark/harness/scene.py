"""The grid scene of the configurations, made on the device from the seed.

Upstream gsplat's profiling scene (`profiling/main.py`, `scene_grid`)
replicates the garden test scene's points in the [-2, 2]^3 crop over a
grid x grid layout of cells 4 units apart.  The garden points are not in
the repository, so each cell holds `n_cell` points drawn uniform in the
crop, as the configuration's `assumed` says, with scales in [1e-4, 0.02],
random unit quaternions, uniform opacities in [1e-4, 1 - 1e-4], sh0 from
random colours and the higher bands at 0.05 sigma.  Every tensor comes from
one torch.Generator on the device, in a few large calls, in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def make_scene(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Raw parameters: means, quats, log scales, logit opacities, sh0
    [N, 1, 3], shN [N, (deg + 1)^2 - 1, 3]."""
    g = generator(seed, device)
    n_cell, grid = cfg["n_cell"], cfg["grid"]
    lo, hi = cfg["scale_range"]
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    base = torch.rand(n_cell, 3, **f32) * 4.0 - 2.0
    colors = torch.rand(n_cell, 3, **f32)
    r = torch.arange(-(grid // 2), grid // 2 + 1, device=device, dtype=torch.float32)
    gx, gy = torch.meshgrid(r, r, indexing="ij")
    offsets = torch.stack([gx, gy, torch.zeros_like(gx)], -1).reshape(-1, 3) * cfg["cell_spacing"]
    means = (base[None] + offsets[:, None]).reshape(-1, 3)
    n = means.shape[0]
    if n != cfg["n_gaussians"]:
        raise ValueError(f"{n_cell} points x {grid}^2 cells make {n} gaussians, not the "
                         f"configuration's n_gaussians {cfg['n_gaussians']}")
    scales = torch.rand(n, 3, **f32) * (hi - lo) + lo
    quats = torch.randn(n, 4, **f32)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    opac = torch.clamp(torch.rand(n, **f32), 1e-4, 1 - 1e-4)
    k = (cfg["sh_degree"] + 1) ** 2 - 1
    return {
        "means": means,
        "quats": quats,
        "scales": torch.log(scales),
        "opacities": torch.log(opac / (1.0 - opac)),
        "sh0": ((colors - 0.5) / SH_C0).repeat(grid * grid, 1)[:, None, :],
        "shN": torch.randn(n, k, 3, **f32) * cfg["shN_sigma"],
    }
