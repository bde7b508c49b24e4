"""The AV trainer: joint camera and spinning-lidar supervision.

Port of `examples/av_trainer.py` (Config :45-63, synthetic_scene :66-102,
AVRunner :158-322) on the `synthetic` data path.  Each step renders the
cameras through the classic rasterizer and the lidar through
`rasterization(camera_model="lidar", with_ut=True, with_eval3d=True,
render_mode="RGB-d")`, and minimises

    (1 - ssim_lambda) l1 + ssim_lambda (1 - SSIM)          on the cameras
  + lidar_distance_lambda  lidar_distance_loss             on the valid rays
  + lidar_background_lambda lidar_background_loss          on the empty rays

with selective Adam over the gaussians some camera sees.  In the synthetic
regime the targets are rendered from the initial state, then the means are
perturbed by 0.05 times a normal draw (from a `torch.Generator` seeded by
`cfg.seed`, or the `noise` handed to `train`).  The JAX runner also builds
an MCMC strategy state that its loop never uses; the port leaves it out.
The `ncore` data path (NCore SDK, examples/datasets/ncore.py) is not ported.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .losses import l1_loss, lidar_background_loss, lidar_distance_loss, ssim_loss
from .optimizers.adam import adam_init, selective_adam_update
from .rendering import rasterization
from .sensors.lidars import SpinningDirection, make_lidar


@dataclass
class Config:
    data: str = "synthetic"
    max_steps: int = 500
    cap_max: int = 8192
    seed: int = 0
    # loss weights
    ssim_lambda: float = 0.2
    lidar_distance_lambda: float = 0.1
    lidar_background_lambda: float = 0.01
    # learning rates (the simple trainer's defaults)
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    opacities_lr: float = 5e-2
    quats_lr: float = 1e-3
    colors_lr: float = 2.5e-3
    near_plane: float = 0.01
    far_plane: float = 200.0
    isect_capacity: int = 1 << 19


def synthetic_scene(seed: int = 0, n_cams: int = 3, W: int = 96, H: int = 64,
                    device: DeviceLike = None) -> Dict:
    """A wall and a ground plane seen by `n_cams` cameras looking along +x
    and by a frontal lidar (24 rows, 128 columns over +-55 degrees); the
    lidar's tables on `device` (the card unless named)."""
    rng = np.random.default_rng(seed)
    n = 600
    pts = np.concatenate([
        np.c_[np.full(n // 2, 6.0) + rng.normal(0, 0.05, n // 2),
              rng.uniform(-4, 4, n // 2), rng.uniform(-1, 2, n // 2)],
        np.c_[rng.uniform(1, 6, n // 2), rng.uniform(-4, 4, n // 2),
              np.full(n // 2, -1.0) + rng.normal(0, 0.05, n // 2)],
    ]).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)

    # the cameras look along +x (the sensor frame is z-forward)
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for c in range(n_cams):
        viewmats[c, :3, :3] = R
        viewmats[c, :3, 3] = R @ -np.array([0.0, -1.5 + 1.5 * c, 0.3], np.float32)
    Ks = np.tile(np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32),
                 (n_cams, 1, 1))
    lidar = make_lidar(
        np.linspace(0.3, -0.45, 24).astype(np.float32),
        np.linspace(math.radians(55), math.radians(-55), 128).astype(np.float32),
        np.zeros(24, np.float32), SpinningDirection.CLOCKWISE, device=device,
    )
    return dict(points=pts, rgb=rgb, viewmats=viewmats, Ks=Ks, W=W, H=H, lidar=lidar,
                lidar_viewmats=np.eye(4, dtype=np.float32)[None])


class AVRunner:
    """Cameras and a lidar trained jointly on one device (the card unless
    named).  Parameters live in `params` as plain tensors, `cap_max` rows
    of which the first len(points) are alive."""

    def __init__(self, cfg: Config, scene: Dict, device: DeviceLike = None):
        self.cfg = cfg
        self.scene = scene
        self.device = dev = resolve_device(device)
        cap = cfg.cap_max
        pts = scene["points"]
        n0 = pts.shape[0]
        rng = np.random.default_rng(cfg.seed)

        def pad(x, fill=0.0):
            out = np.full((cap,) + x.shape[1:], fill, np.float32)
            out[: x.shape[0]] = x
            return torch.from_numpy(out).to(dev)

        d = np.linalg.norm(pts - pts[rng.integers(0, n0, n0)], axis=-1, keepdims=True) + 1e-2
        rgb = scene["rgb"]
        self.params = dict(
            means=pad(pts),
            scales=pad(np.log(np.repeat(d * 0.3, 3, axis=1))),
            quats=pad(np.tile([1.0, 0, 0, 0], (n0, 1))),
            opacities=pad(np.full(n0, 0.5), fill=-10.0),
            colors=pad(np.log(rgb / (1 - rgb + 1e-6))),
        )
        self.alive = torch.arange(cap, device=dev) < n0
        self.opt_state = adam_init(self.params)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.lrs = {"means": cfg.means_lr * 8.0, "scales": cfg.scales_lr,
                    "opacities": cfg.opacities_lr, "quats": cfg.quats_lr,
                    "colors": cfg.colors_lr}
        self.lidar = scene["lidar"].to(dev) if scene.get("lidar") is not None else None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.device)

    def render_cams(self, p, alive, viewmats, Ks):
        op = torch.where(alive, torch.sigmoid(p["opacities"]), 0.0)
        return rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), op, torch.sigmoid(p["colors"]),
            viewmats, Ks, self.scene["W"], self.scene["H"], near_plane=self.cfg.near_plane,
            far_plane=self.cfg.far_plane, isect_capacity=self.cfg.isect_capacity,
        )

    def render_lidar(self, p, alive, viewmats):
        op = torch.where(alive, torch.sigmoid(p["opacities"]), 0.0)
        return rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), op,
            torch.sigmoid(p["colors"][..., :1]), viewmats,
            torch.eye(3, device=self.device)[None], 0, 0, camera_model="lidar",
            lidar_coeffs=self.lidar, with_ut=True, with_eval3d=True, render_mode="RGB-d",
            global_z_order=False, near_plane=self.cfg.near_plane, far_plane=self.cfg.far_plane,
            isect_capacity=self.cfg.isect_capacity,
        )

    @torch.no_grad()
    def make_targets(self):
        """(camera images, lidar hit distances [1, R, C, 1] or None, valid
        rays [1, R, C, 1] or None): the scene's images, or in the synthetic
        regime renders of the initial state; a lidar ray is valid where its
        rendered alpha is above 0.5."""
        if self.scene.get("images") is not None:
            imgs = self._tensor(self.scene["images"])
        else:
            imgs, _, _ = self.render_cams(self.params, self.alive,
                                          self._tensor(self.scene["viewmats"]),
                                          self._tensor(self.scene["Ks"]))
        if self.lidar is None:
            return imgs, None, None
        lr_img, lr_alpha, _ = self.render_lidar(self.params, self.alive,
                                                self._tensor(self.scene["lidar_viewmats"]))
        return imgs, lr_img[..., -1:], lr_alpha > 0.5

    def loss_fn(self, p, alive, cams, Ks, lvm, gt_imgs, gt_dist, gt_valid, pix_mask):
        """The step's scalar loss, its camera meta and its lidar meta (None
        without a lidar; with the two lidar losses, detached, under
        "distance_loss" and "background_loss")."""
        cfg = self.cfg
        colors, _, meta = self.render_cams(p, alive, cams, Ks)
        colors = torch.clamp(colors, 0.0, 1.0)
        tgt = gt_imgs
        if pix_mask is not None:
            colors, tgt = colors * pix_mask, tgt * pix_mask
        loss = l1_loss(colors, tgt) * (1 - cfg.ssim_lambda) + ssim_loss(colors, tgt) * cfg.ssim_lambda
        lmeta = None
        if lvm is not None:
            li, la, lmeta = self.render_lidar(p, alive, lvm)
            dist = lidar_distance_loss(li[..., -1:], gt_dist, gt_valid)
            background = lidar_background_loss(la, ~gt_valid)
            loss = loss + cfg.lidar_distance_lambda * dist + cfg.lidar_background_lambda * background
            lmeta = dict(lmeta, distance_loss=dist.detach(), background_loss=background.detach())
        return loss, meta, lmeta

    def prepare(self, noise: Optional[torch.Tensor] = None) -> Dict:
        """The training inputs: cameras, targets and masks; in the synthetic
        regime the means are then perturbed by 0.05 times `noise` (shaped
        like the means), or by the generator's normal draw."""
        inputs = dict(cams=self._tensor(self.scene["viewmats"]), Ks=self._tensor(self.scene["Ks"]),
                      lvm=(self._tensor(self.scene["lidar_viewmats"])
                           if self.lidar is not None else None))
        inputs["gt_imgs"], inputs["gt_dist"], inputs["gt_valid"] = self.make_targets()
        inputs["pix_mask"] = (self._tensor(self.scene["masks"])[..., None]
                              if self.scene.get("masks") is not None else None)
        if self.scene.get("images") is None:
            # synthetic regime: perturb away from the truth so that training has work
            if noise is None:
                noise = torch.randn(self.params["means"].shape, generator=self.generator)
            self.params["means"] += 0.05 * noise.to(self.device)
        return inputs

    def train_step(self, inputs: Dict):
        """One forward, backward and selective Adam step, in place.  Returns
        (loss, the lidar render's meta or None)."""
        leaves = {k: v.detach().requires_grad_() for k, v in self.params.items()}
        loss, meta, lmeta = self.loss_fn(leaves, self.alive, **inputs)
        loss.backward()
        visibility = (meta["radii"] > 0).all(-1).any(0) & self.alive
        grads = {k: v.grad for k, v in leaves.items()}
        self.params, self.opt_state = selective_adam_update(
            self.params, grads, self.opt_state, self.lrs, visibility=visibility)
        return loss.detach(), lmeta

    def train(self, noise: Optional[torch.Tensor] = None, log=print) -> List[float]:
        """`prepare(noise)`, then `cfg.max_steps` steps; returns the loss at
        every 50th step and at the last."""
        inputs = self.prepare(noise)
        losses = []
        t0 = time.time()
        for step in range(self.cfg.max_steps):
            loss, _ = self.train_step(inputs)
            if step % 50 == 0 or step == self.cfg.max_steps - 1:
                losses.append(float(loss))
                log(f"step {step:5d} loss {losses[-1]:.5f}")
        log(f"trained {self.cfg.max_steps} steps in {time.time() - t0:.1f}s")
        return losses
