"""The 2DGS (surfel) trainer: l1 + ssim plus the normal-consistency and
distortion regularizers, with the default strategy.

Port of `examples/simple_trainer_2dgs.py` (Config :36-41, Runner2DGS :44-137)
on the port's Trainer: the render goes through rasterization_2dgs in RGB+ED
mode with the `densify` carrier as the screen gradient of the default
strategy, which tests and samples only the two tangent scale axes.  The
loss is l1 and ssim, plus normal_lambda * (1 - cos) between the rendered
normals and the normals from the rendered depth (detached) from step
normal_start_iter on, plus dist_lambda * the mean distortion from step
dist_start_iter on.  (The JAX runner counts those steps per SH degree, since
its counter lives in each degree's compiled step; here they are the
training steps.)

Only the alive rows of the capacity-padded model are rendered.  The JAX
runner renders every row with opacity 0 where not alive; unlike the 3DGS
projection, the surfel projection does not cull by opacity, so the dead
rows (zero-padded: unit scales at the origin) still emit their tile slots
and count against the intersection capacity, though they add nothing to
the image.  Their gradients are zero in both.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .losses import l1_loss, normal_cosine_loss, ssim_loss
from .rendering import rasterization_2dgs
from .trainer import Config, Trainer


@dataclasses.dataclass
class Config2DGS(Config):
    normal_lambda: float = 0.05
    dist_lambda: float = 0.01
    normal_start_iter: int = 7000
    dist_start_iter: int = 3000


class Trainer2DGS(Trainer):
    """The surfel model on the Trainer's loop, checkpoints and strategy."""

    strategy_scale_axes: Tuple[int, ...] = (0, 1)

    def render(self, params, alive, viewmats, Ks, sh_degree, offset=None):
        """RGB renders [C, H, W, 3], alphas and meta of the alive rows;
        meta["radii"] covers every row (0 where not alive) and meta["_2dgs"]
        holds the world-frame normals, the normals from depth and the
        distortion."""
        idx = torch.nonzero(alive)[:, 0]
        take = lambda k: params[k].index_select(0, idx)
        render, alphas, normals, nfd, distort, _, meta = rasterization_2dgs(
            take("means"), take("quats"), torch.exp(take("scales")),
            torch.sigmoid(take("opacities")), torch.cat([take("sh0"), take("shN")], dim=1),
            viewmats, Ks, self.width, self.height, sh_degree=sh_degree,
            near_plane=self.cfg.near_plane, far_plane=self.cfg.far_plane, render_mode="RGB+ED",
            isect_capacity=self.cfg.isect_capacity,
            densify=None if offset is None else offset.index_select(1, idx),
        )
        radii = torch.zeros((viewmats.shape[0],) + alive.shape + (2,), dtype=torch.int32,
                            device=alive.device)
        radii[:, idx] = meta["radii"]
        meta["radii"] = radii
        meta["_2dgs"] = (normals, nfd, distort)
        return render[..., :3], alphas, meta

    def loss_fn(self, params, alive, viewmats, Ks, pixels, sh_degree, offset=None, step=0):
        cfg = self.cfg
        colors, _, meta = self.render(params, alive, viewmats, Ks, sh_degree, offset=offset)
        colors = torch.clamp(colors, 0.0, 1.0)
        loss = l1_loss(colors, pixels) * (1.0 - cfg.ssim_lambda)
        loss = loss + ssim_loss(colors, pixels) * cfg.ssim_lambda
        normals, nfd, distort = meta["_2dgs"]
        if step >= cfg.normal_start_iter:
            loss = loss + cfg.normal_lambda * normal_cosine_loss(normals, nfd.detach())
        if step >= cfg.dist_start_iter:
            loss = loss + cfg.dist_lambda * torch.mean(distort)
        return loss, meta
