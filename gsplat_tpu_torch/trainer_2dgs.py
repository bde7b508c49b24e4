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

The surfel composite has no packed mode: `Config.pack_payload` and
`pack_grads`, inherited from the 3DGS config, are not read here.

The step takes none of the 3DGS trainer's add-ons: the JAX 2DGS runner's
loss (`examples/simple_trainer_2dgs.py:87-123`) renders the given cameras
with the SH colours and nothing after the render, and returns no add-on
gradient.  So `pose_opt`, `app_opt`, `bilateral_grid` and `ppisp` raise a
ValueError here.  What acts outside the step is inherited: `pose_noise`,
`render_traj`, `compression` and TensorBoard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch

from ._device import DeviceLike
from .losses import l1_loss, normal_cosine_loss, ssim_loss
from .rendering import rasterization_2dgs
from .trainer import Config, Trainer
from .utils.trace import trace_range

# the 3DGS step's add-ons, which the surfel step does not take
ADDONS = ("pose_opt", "app_opt", "bilateral_grid", "ppisp")


@dataclasses.dataclass
class Config2DGS(Config):
    normal_lambda: float = 0.05
    dist_lambda: float = 0.01
    normal_start_iter: int = 7000
    dist_start_iter: int = 3000


class Trainer2DGS(Trainer):
    """The surfel model on the Trainer's loop, checkpoints and strategy."""

    strategy_scale_axes: Tuple[int, ...] = (0, 1)

    def __init__(self, cfg: Config, data: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None):
        on = [name for name in ADDONS if getattr(cfg, name)]
        if on:
            raise ValueError(f"the 2DGS trainer takes none of the add-ons {on}, as the JAX "
                             "2DGS runner's step")
        if cfg.with_ut or cfg.with_eval3d or cfg.radial_coeffs:
            raise ValueError("the 2DGS trainer projects surfels: with_ut, with_eval3d and "
                             "radial_coeffs apply to the 3DGS trainer")
        super().__init__(cfg, data=data, device=device)

    def render(self, params, alive, viewmats, Ks, sh_degree, offset=None, app=None,
               cam_ids=None):
        """RGB renders [C, H, W, 3], alphas and meta of the alive rows;
        meta["radii"] covers every row (0 where not alive) and meta["_2dgs"]
        holds the world-frame normals, the normals from depth and the
        distortion.  `app` and `cam_ids` are the 3DGS render's arguments,
        always None here (no add-on)."""
        with trace_range("project"):
            idx = torch.nonzero(alive)[:, 0]
            take = lambda k: params[k].index_select(0, idx)
            rows = (take("means"), take("quats"), torch.exp(take("scales")),
                    torch.sigmoid(take("opacities")), torch.cat([take("sh0"), take("shN")], dim=1))
            densify = None if offset is None else offset.index_select(1, idx)
        render, alphas, normals, nfd, distort, _, meta = rasterization_2dgs(
            *rows, viewmats, Ks, self.width, self.height, sh_degree=sh_degree,
            near_plane=self.cfg.near_plane, far_plane=self.cfg.far_plane, render_mode="RGB+ED",
            isect_capacity=self.cfg.isect_capacity, densify=densify,
        )
        with trace_range("composite"):
            radii = torch.zeros((viewmats.shape[0],) + alive.shape + (2,), dtype=torch.int32,
                                device=alive.device)
            radii[:, idx] = meta["radii"]
        meta["radii"] = radii
        meta["_2dgs"] = (normals, nfd, distort)
        return render[..., :3], alphas, meta

    def loss_fn(self, params, alive, viewmats, Ks, pixels, sh_degree, offset=None, step=0):
        cfg = self.cfg
        colors, _, meta = self.render(params, alive, viewmats, Ks, sh_degree, offset=offset)
        with trace_range("loss"):
            colors = torch.clamp(colors, 0.0, 1.0)
            loss = l1_loss(colors, pixels) * (1.0 - cfg.ssim_lambda)
            loss = loss + ssim_loss(colors, pixels) * cfg.ssim_lambda
            normals, nfd, distort = meta["_2dgs"]
            if step >= cfg.normal_start_iter:
                loss = loss + cfg.normal_lambda * normal_cosine_loss(normals, nfd.detach())
            if step >= cfg.dist_start_iter:
                loss = loss + cfg.dist_lambda * torch.mean(distort)
        return loss, meta
