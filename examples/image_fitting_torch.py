"""Fit random 3D gaussians to one image with the PyTorch port.

Port of examples/image_fitting.py: random gaussians (numpy, seed 42) in
front of one fov-90 camera at z = +8, Adam (lr 0.01, eps 1e-8) on every
parameter, the mean squared error.  Runs on the CUDA card unless --device
names another; on the CPU the kernels' plain versions run.  --img_path
reads a PNG through the port's decoder (no PIL).

Usage:
    python examples/image_fitting_torch.py --height 256 --width 256 --iterations 1000 [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch._device import resolve_device  # noqa: E402
from gsplat_tpu_torch.datasets.colmap import load_image  # noqa: E402
from gsplat_tpu_torch.losses import mse_loss  # noqa: E402
from gsplat_tpu_torch.optimizers import adam_init, adam_update  # noqa: E402
from gsplat_tpu_torch.rendering import rasterization  # noqa: E402


def default_target(height: int, width: int) -> np.ndarray:
    """A synthetic target (no bundled assets): smooth colour ramps and rings."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = x / width, y / height
    r = np.sqrt((u - 0.5) ** 2 + (v - 0.5) ** 2)
    img = np.stack([u, v, 0.5 + 0.5 * np.sin(12.0 * r)], axis=-1).astype(np.float32)
    return np.clip(img, 0, 1)


class SimpleTrainer:
    """Trains random gaussians to fit an image, on `device` (the card
    unless named)."""

    def __init__(self, gt_image: np.ndarray, num_points: int = 2000, seed: int = 42,
                 device=None):
        self.device = dev = resolve_device(device)
        self.gt_image = torch.from_numpy(np.asarray(gt_image, np.float32)).to(dev)
        self.num_points = num_points
        self.H, self.W = gt_image.shape[0], gt_image.shape[1]
        fov_x = math.pi / 2.0
        self.focal = 0.5 * float(self.W) / math.tan(0.5 * fov_x)

        rng = np.random.default_rng(seed)
        bd = 2.0
        means = bd * (rng.random((num_points, 3), dtype=np.float32) - 0.5)
        scales = rng.random((num_points, 3), dtype=np.float32)
        rgbs = rng.random((num_points, 3), dtype=np.float32)
        u, v, w = (rng.random((num_points, 1), dtype=np.float32) for _ in range(3))
        quats = np.concatenate([
            np.sqrt(1.0 - u) * np.sin(2 * math.pi * v),
            np.sqrt(1.0 - u) * np.cos(2 * math.pi * v),
            np.sqrt(u) * np.sin(2 * math.pi * w),
            np.sqrt(u) * np.cos(2 * math.pi * w),
        ], axis=-1)
        t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
        self.params = {"means": t(means), "scales": t(scales), "quats": t(quats),
                       "rgbs": t(rgbs), "opacities": torch.ones(num_points, device=dev)}
        self.viewmat = t([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 8.0],
                          [0.0, 0.0, 0.0, 1.0]])[None]
        self.K = t([[self.focal, 0, self.W / 2], [0, self.focal, self.H / 2], [0, 0, 1]])[None]

    def render(self, params):
        colors, _, _ = rasterization(
            params["means"], params["quats"], params["scales"],
            torch.sigmoid(params["opacities"]), torch.sigmoid(params["rgbs"]), self.viewmat,
            self.K, self.W, self.H, isect_capacity=max(16 * self.num_points, 1 << 14))
        return colors[0]

    def train_step(self, opt_state, lr: float = 0.01):
        """One forward, backward and Adam step, in place; returns (the loss
        before the step, detached, and the new Adam state)."""
        leaves = {k: v.detach().requires_grad_() for k, v in self.params.items()}
        loss = mse_loss(self.render(leaves), self.gt_image)
        loss.backward()
        self.params, opt_state = adam_update(self.params, {k: v.grad for k, v in leaves.items()},
                                             opt_state, lr, eps=1e-8)
        return loss.detach(), opt_state

    def train(self, iterations: int = 1000, lr: float = 0.01, log=print) -> float:
        opt_state = adam_init(self.params)
        t0 = time.time()
        for it in range(iterations):
            loss, opt_state = self.train_step(opt_state, lr)
            if it % 100 == 0 or it == iterations - 1:
                log(f"iter {it}: mse {float(loss):.6f}")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        log(f"total {time.time() - t0:.1f}s")
        return float(loss)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--num_points", type=int, default=2000)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--img_path", type=str, default=None)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args()
    gt = load_image(args.img_path) if args.img_path else default_target(args.height,
                                                                          args.width)
    trainer = SimpleTrainer(gt, num_points=args.num_points, device=args.device)
    trainer.train(iterations=args.iterations, lr=args.lr)


if __name__ == "__main__":
    main()
