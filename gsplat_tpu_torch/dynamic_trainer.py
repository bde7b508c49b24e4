"""The dynamic (deformable) scene trainer: the G-SHARP surgical recipe.

Port of `examples/dynamic_surgical_trainer.py` (Config :43-56,
synthetic_dynamic_scene :59-90, endonerf_scene :93-169, run_training
:192-352).  Gaussians carry a dynamic mask; before rasterization the
dynamic ones go through the HexPlane field and the deform network
(contrib/dynamic), which give time-dependent deltas on (means, quats,
opacities).  Each step minimises

    (1 - ssim_lambda) l1 + ssim_lambda (1 - SSIM)    (masked to the tissue on
                                                      EndoNeRF data)
  + lambda_hexplane_reg  hexplane_regularization

with selective Adam over the gaussians the camera sees and Adam for the
planes and the network, which are not per-gaussian and so have optimizers
of their own.  The data are the synthetic oscillating blob over a static
background (the targets rendered from the true displaced scenes) or an
EndoNeRF directory (datasets/endonerf.py: frames, depth-unprojected
initial points, tool masks), resized as PIL resizes (datasets/resize.py).

`DynamicRunner` holds the state and takes one step at a time
(`train_step`); `run_training` is the JAX function's loop.  The planes and
the network start from a `torch.Generator` seeded by `cfg.seed`, or from
the JAX runner's draws carried across (`hex_params`, `deform_params`, from
`scene.convert.hexplane_from_numpy` / `deform_params_from_numpy`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .contrib.dynamic import (
    deform_network_apply,
    deform_network_init,
    hexplane_apply,
    hexplane_init,
    hexplane_regularization,
)
from .datasets.endonerf import EndoNeRFDataset, EndoNeRFParser
from .datasets.resize import resize_bilinear_u8, resize_nearest
from .losses import l1_loss, masked_l1, masked_ssim, ssim_loss
from .optimizers.adam import adam_init, adam_update, selective_adam_update
from .rendering import rasterization

HEX_CONFIG = dict(grid_dimensions=2, input_coordinate_dim=4, output_coordinate_dim=16,
                  resolution=[24, 24, 24, 12])
ISECT_CAPACITY = 1 << 18


@dataclass
class Config:
    max_steps: int = 300
    cap: int = 2048
    W: int = 80
    H: int = 60
    n_times: int = 6
    seed: int = 0
    ssim_lambda: float = 0.2
    lambda_hexplane_reg: float = 1e-4
    lr_splats_means: float = 2e-3
    lr_splats: float = 5e-3
    lr_hexplane: float = 5e-3
    lr_deform: float = 1.6e-3


def synthetic_dynamic_scene(cfg: Config) -> Dict:
    """A static ground and an oscillating cluster; the camera is fixed and
    time varies (numpy, from `cfg.seed`)."""
    rng = np.random.default_rng(cfg.seed)
    n_static, n_dyn = 400, 120
    static = np.c_[rng.uniform(-2, 2, n_static), rng.uniform(-1.5, 1.5, n_static),
                   rng.uniform(3.5, 5.0, n_static)].astype(np.float32)
    dyn0 = np.c_[rng.normal(0, 0.25, n_dyn), rng.normal(0, 0.25, n_dyn),
                 rng.normal(4.0, 0.15, n_dyn)].astype(np.float32)
    pts = np.concatenate([static, dyn0])
    rgb = rng.uniform(0.1, 0.9, (len(pts), 3)).astype(np.float32)
    dyn_mask = np.zeros(len(pts), bool)
    dyn_mask[n_static:] = True
    viewmats = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[60.0, 0, cfg.W / 2], [0, 60.0, cfg.H / 2], [0, 0, 1]]], np.float32)
    times = np.linspace(0, 1, cfg.n_times).astype(np.float32)

    def displaced(t):
        out = pts.copy()
        out[n_static:, 0] += 0.35 * np.sin(2 * np.pi * t)
        out[n_static:, 1] += 0.2 * np.cos(2 * np.pi * t)
        return out

    return dict(points=pts, rgb=rgb, dyn_mask=dyn_mask, viewmats=viewmats, Ks=Ks, times=times,
                displaced=displaced)


def endonerf_scene(cfg: Config, data_dir: str, factor: int = 4, max_frames: int = 6) -> Dict:
    """EndoNeRF frames and a depth-unprojected start (numpy): the gaussians
    start at frame 0's depth, unprojected through K at the tissue pixels
    (at most cfg.cap * 3 // 4 of them, chosen from `cfg.seed`); every
    gaussian is dynamic; the tool masks gate the loss.  Sets cfg.W, cfg.H
    and cfg.n_times, as the JAX function does."""
    parser = EndoNeRFParser(data_dir)
    ds = EndoNeRFDataset(parser, split="video")
    n_t = min(len(ds), max_frames)
    W, H = parser.width // factor, parser.height // factor
    K = parser.K.copy()
    K[:2] /= factor

    imgs, masks, viewmats, times = [], [], [], []
    depth0 = None
    for i in range(n_t):
        it = ds[i]
        imgs.append(resize_bilinear_u8((it["image"] * 255).astype(np.uint8), W, H)
                    .astype(np.float32) / 255.0)
        masks.append(resize_nearest((it["mask"] * 255).astype(np.uint8), W, H)
                     .astype(np.float32) / 255.0)
        times.append(float(it["time"]))
        c2w = it["camtoworld"].astype(np.float64)
        w2c = np.eye(4)
        w2c[:3, :3] = c2w[:3, :3].T
        w2c[:3, 3] = -c2w[:3, :3].T @ c2w[:3, 3]
        viewmats.append(w2c.astype(np.float32))
        if i == 0:
            depth0 = resize_nearest(it["depth"], W, H).astype(np.float32)

    # the start: frame 0's depth unprojected at valid tissue pixels
    yy, xx = np.mgrid[0:H, 0:W]
    valid = (depth0 > 0) & (masks[0] > 0.5)
    z = depth0[valid]
    x = (xx[valid] + 0.5 - K[0, 2]) / K[0, 0] * z
    y = (yy[valid] + 0.5 - K[1, 2]) / K[1, 1] * z
    cam_pts = np.stack([x, y, z], -1)
    c2w0 = ds[0]["camtoworld"].astype(np.float64)
    pts = cam_pts @ c2w0[:3, :3].T + c2w0[:3, 3]
    rgb = imgs[0][valid]
    keep = np.random.default_rng(cfg.seed).choice(len(pts), min(len(pts), cfg.cap * 3 // 4),
                                                  replace=False)
    cfg.W, cfg.H, cfg.n_times = W, H, n_t
    return dict(
        points=pts[keep].astype(np.float32),
        # about a 2-pixel footprint at the observed depth
        scale0=np.maximum(2.0 * z[keep] / K[0, 0], 1e-4).astype(np.float32),
        rgb=np.clip(rgb[keep].astype(np.float32), 1e-3, 1 - 1e-3),
        dyn_mask=np.ones(len(keep), bool),  # the whole tissue deforms
        viewmats=np.stack(viewmats)[:, None],  # [T, 1, 4, 4]
        Ks=np.tile(K[None], (1, 1, 1)),
        times=np.asarray(times, np.float32),
        gt=np.stack(imgs)[:, None],  # [T, 1, H, W, 3]
        masks=np.stack(masks)[:, None, :, :, None],  # [T, 1, H, W, 1]
    )


def _flat_grids(grids) -> Dict[str, torch.Tensor]:
    return {f"{s}.{i}": p for s, scale in enumerate(grids) for i, p in enumerate(scale)}


def _flat_deform(params) -> Dict[str, torch.Tensor]:
    flat = {f"trunk.{i}.{k}": v for i, layer in enumerate(params["trunk"])
            for k, v in layer.items()}
    flat.update({f"{h}.{k}": v for h in ("pos", "quat", "opacity") for k, v in params[h].items()})
    return flat


def _deform_tree(flat: Dict[str, torch.Tensor], n_layers: int) -> Dict:
    tree = {"trunk": [{k: flat[f"trunk.{i}.{k}"] for k in ("w", "b")} for i in range(n_layers)]}
    tree.update({h: {k: flat[f"{h}.{k}"] for k in ("w", "b")} for h in ("pos", "quat", "opacity")})
    return tree


class DynamicRunner:
    """The dynamic trainer's state on one device (the card unless named):
    the capacity-padded gaussians (`cfg.cap` rows, the first len(points)
    alive), the HexPlane grids and the deform network, three Adam states,
    and the per-time targets."""

    def __init__(self, cfg: Config, scene: Dict, device: DeviceLike = None,
                 hex_params: Optional[Dict] = None, deform_params: Optional[Dict] = None):
        self.cfg = cfg
        self.scene = scene
        self.device = dev = resolve_device(device)
        cap = cfg.cap
        n0 = len(scene["points"])

        def pad(x, fill=0.0):
            out = np.full((cap,) + x.shape[1:], fill, np.float32)
            out[: x.shape[0]] = x
            return torch.from_numpy(out).to(dev)

        scale0 = np.asarray(scene.get("scale0", 0.06), np.float32).reshape(-1, 1)
        self.params = dict(
            means=pad(scene["points"]),
            scales=pad(np.log(np.broadcast_to(scale0, (n0, 3))).astype(np.float32)),
            quats=pad(np.tile([1.0, 0, 0, 0], (n0, 1))),
            opacities=pad(np.full(n0, 1.5, np.float32), fill=-10.0),
            colors=pad(np.log(scene["rgb"] / (1 - scene["rgb"] + 1e-6))),
        )
        self.alive = torch.arange(cap, device=dev) < n0
        self.dyn_mask = torch.from_numpy(np.pad(scene["dyn_mask"], (0, cap - n0))).to(dev)

        generator = torch.Generator().manual_seed(cfg.seed)
        if hex_params is None:
            hex_params = hexplane_init(generator, bounds=6.0, planes_config=HEX_CONFIG,
                                       multires=(1,), device=dev)
        if deform_params is None:
            deform_params = deform_network_init(generator, feature_dim=hex_params["feat_dim"],
                                                hidden_dim=48, num_layers=2, device=dev)
        self.hex_params = hex_params  # the grids train; the AABB and the layout do not
        self.n_layers = len(deform_params["trunk"])
        self.hex_train = _flat_grids(hex_params["grids"])
        self.deform_train = _flat_deform(deform_params)
        self.opt_splats = adam_init(self.params)
        self.opt_hex = adam_init(self.hex_train)
        self.opt_deform = adam_init(self.deform_train)
        self.lrs_splats = dict(means=cfg.lr_splats_means, scales=cfg.lr_splats,
                               quats=cfg.lr_splats, opacities=cfg.lr_splats, colors=cfg.lr_splats)

        self.Ks = torch.from_numpy(np.asarray(scene["Ks"], np.float32)).to(dev)
        vm = np.asarray(scene["viewmats"], np.float32)
        if vm.ndim == 3:  # the synthetic camera set is the same at every time
            vm = np.tile(vm[None], (cfg.n_times, 1, 1, 1))
        self.viewmats_t = torch.from_numpy(vm).to(dev)  # [T, C, 4, 4]
        self.gt, self.loss_masks = self.make_targets()

    def _hexplane(self, grids: Dict[str, torch.Tensor]) -> Dict:
        hp = dict(self.hex_params)
        hp["grids"] = [[grids[f"{s}.{i}"] for i in range(len(scale))]
                       for s, scale in enumerate(self.hex_params["grids"])]
        return hp

    def render(self, p, t: float, viewmats, grids, deform):
        """The deformation (HexPlane features at (xyz, t) -> deltas, only
        where dyn_mask), then rasterization() of the capacity rows."""
        cap = self.cfg.cap
        xyzt = torch.cat([p["means"], torch.full((cap, 1), t, device=self.device)], dim=1)
        feats = hexplane_apply(self._hexplane(grids), xyzt)
        m2, q2, o2 = deform_network_apply(_deform_tree(deform, self.n_layers), p["means"],
                                          p["quats"], p["opacities"][:, None], None, feats)
        sel = self.dyn_mask[:, None]
        means = torch.where(sel, m2, p["means"])
        quats = torch.where(sel, q2, p["quats"])
        opac = torch.where(self.dyn_mask, o2[:, 0], p["opacities"])
        op = torch.where(self.alive, torch.sigmoid(opac), 0.0)
        return rasterization(means, quats, torch.exp(p["scales"]), op, torch.sigmoid(p["colors"]),
                             viewmats, self.Ks, self.cfg.W, self.cfg.H,
                             isect_capacity=ISECT_CAPACITY)

    @torch.no_grad()
    def make_targets(self):
        """([T, C, H, W, 3] targets, [T, C, H, W, 1] tissue masks or None):
        the scene's frames, or in the synthetic regime renders of the true
        displaced scenes."""
        if self.scene.get("gt") is not None:
            gt = torch.from_numpy(np.asarray(self.scene["gt"], np.float32)).to(self.device)
            masks = self.scene.get("masks")
            return gt, (None if masks is None
                        else torch.from_numpy(np.asarray(masks, np.float32)).to(self.device))
        p = self.params
        outs = []
        for ti, t in enumerate(self.scene["times"]):
            means = torch.from_numpy(self.scene["displaced"](float(t))).to(self.device)
            means = torch.cat([means, p["means"][len(means):]])
            img, _, _ = rasterization(
                means, p["quats"], torch.exp(p["scales"]),
                torch.where(self.alive, torch.sigmoid(p["opacities"]), 0.0),
                torch.sigmoid(p["colors"]), self.viewmats_t[ti], self.Ks, self.cfg.W,
                self.cfg.H, isect_capacity=ISECT_CAPACITY)
            outs.append(img)
        return torch.stack(outs), None

    def loss_fn(self, p, grids, deform, ti: int):
        """The loss of time index `ti` (the tissue-masked l1 and SSIM on
        EndoNeRF data) and the render's meta."""
        cfg = self.cfg
        img, _, meta = self.render(p, float(self.scene["times"][ti]), self.viewmats_t[ti], grids,
                                   deform)
        img = torch.clamp(img, 0, 1)
        gt_img = self.gt[ti]
        if self.loss_masks is not None:
            # the tissue mask: tool pixels are left out of the loss
            mask_img = self.loss_masks[ti]
            loss = masked_l1(img, gt_img, mask_img) * (1 - cfg.ssim_lambda)
            loss = loss + (1.0 - masked_ssim(img, gt_img, mask_img)) * cfg.ssim_lambda
        else:
            loss = l1_loss(img, gt_img) * (1 - cfg.ssim_lambda)
            loss = loss + ssim_loss(img, gt_img) * cfg.ssim_lambda
        loss = loss + cfg.lambda_hexplane_reg * hexplane_regularization(self._hexplane(grids))
        return loss, meta

    def train_step(self, step: int) -> torch.Tensor:
        """One forward, backward and update at time step % n_times, in
        place; returns the loss (detached)."""
        cfg = self.cfg
        leaves = [{k: v.detach().requires_grad_() for k, v in d.items()}
                  for d in (self.params, self.hex_train, self.deform_train)]
        loss, meta = self.loss_fn(*leaves, step % cfg.n_times)
        loss.backward()
        vis = (meta["radii"] > 0).all(dim=-1).any(dim=0) & self.alive
        grads = [{k: v.grad for k, v in d.items()} for d in leaves]
        self.params, self.opt_splats = selective_adam_update(
            self.params, grads[0], self.opt_splats, self.lrs_splats, visibility=vis)
        self.hex_train, self.opt_hex = adam_update(self.hex_train, grads[1], self.opt_hex,
                                                   cfg.lr_hexplane)
        self.deform_train, self.opt_deform = adam_update(self.deform_train, grads[2],
                                                         self.opt_deform, cfg.lr_deform)
        return loss.detach()


def run_training(cfg: Config, scene: Dict, device: DeviceLike = None,
                 hex_params: Optional[Dict] = None, deform_params: Optional[Dict] = None,
                 log=print) -> List[float]:
    """Train for cfg.max_steps steps; returns the loss at every 50th step
    and at the last, as the JAX function does."""
    runner = DynamicRunner(cfg, scene, device, hex_params, deform_params)
    t0 = time.time()
    losses = []
    for step in range(cfg.max_steps):
        loss = runner.train_step(step)
        if step % 50 == 0 or step == cfg.max_steps - 1:
            losses.append(float(loss))
            log(f"step {step:5d} t={step % cfg.n_times} loss {losses[-1]:.5f}")
    log(f"trained {cfg.max_steps} steps in {time.time() - t0:.1f}s")
    return losses
