"""The 3DGS trainer: render -> l1 + ssim -> backward -> selective Adam ->
densification strategy (default or MCMC), on a capacity-padded model with an
`alive` mask.

Port of `examples/simple_trainer.py` (Config, knn_mean_dist, create_splats,
Runner.__init__ on its npz branch with either strategy, render,
make_train_step, make_update_step, train, _make_npz_targets, eval with PSNR
only, _save, _load) for the float32 payload path (the JAX trainer's
`pack_payload=False, pack_grads=False`).  The model has a static capacity
(`capacity`, 0 meaning 6x the initial points, for the default strategy;
`cap_max` for MCMC) as in the JAX trainer, so the two compare step by step:
the same seed gives the same initial parameters and the same batch order.

The data is an npz-like mapping {means3d [N, 3], colors [N, 3] in 0..255,
viewmats [V, 4, 4], Ks [V, 3, 3], width, height}: pass it as `data`, or name
a `.npz` file in `Config.data_dir` (or the GSPLAT_TPU_TEST_DATA environment
variable).  Targets are clean renders of the full point cloud; the last view
is held out.  The trainer runs on the card unless `device="cpu"`.

Not ported yet (ROADMAP Queue 1): the packed payloads (item 5), and pose /
bilateral-grid / appearance / PPISP options, the viewer, TensorBoard,
trajectories, PLY export and compression (item 12).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .losses import l1_loss, ssim_loss
from .optimizers import AdamState, adam_init, selective_adam_update
from .rendering import rasterization
from .scene.convert import train_state_from_numpy, train_state_to_numpy
from .strategy import DefaultStrategy, MCMCStrategy
from .training import exponential_lr

SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class Config:
    strategy: str = "default"  # "default" | "mcmc"
    data: str = "npz"  # only "npz" is ported
    data_dir: str = ""  # path of the .npz file when no arrays are passed
    result_dir: str = "results/run"
    max_steps: int = 30_000
    batch_size: int = 1
    init_opacity: float = 0.1
    init_scale: float = 1.0  # multiplier on the knn-based scale init
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    ssim_lambda: float = 0.2
    near_plane: float = 0.01
    far_plane: float = 1e10
    isect_capacity: int = 4 * 1024 * 1024
    # row-record capacity of the rasterizer's tight plan; 0 = isect_capacity // 2
    row_capacity: int = 0
    capacity: int = 0  # default-strategy capacity; 0 = 6x the initial points
    cap_max: int = 1_000_000  # MCMC capacity
    refine_every: int = 100
    # the default strategy's densify threshold (mean screen-gradient norm in pixels)
    grow_grad2d: float = 2e-4
    eval_every: int = 7000
    save_every: int = 7000
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    grad_clip: float = 0.0  # global-norm clip on the splat gradients, 0 = off
    seed: int = 42
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    opacities_lr: float = 5e-2
    quats_lr: float = 1e-3
    sh0_lr: float = 2.5e-3
    shN_lr: float = 2.5e-3 / 20
    ckpt: str = ""  # resume from a checkpoint written by _save
    mcmc_noise_stop: int = -1  # stop noise injection at this step; -1 = never stop
    fixed_batch: bool = False  # step over the train views in order
    npz_subsample: int = 1  # train from every k-th point against full-cloud targets


def knn_mean_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """Mean distance to the k-1 nearest neighbours (scale init), on the host."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k, workers=-1)
    return d[:, 1:].mean(axis=1)


def create_splats(points: np.ndarray, rgbs: np.ndarray, capacity: int, cfg: Config,
                  device: torch.device, dist: Optional[np.ndarray] = None):
    """Initial gaussian parameters in capacity-padded tensors and the alive
    mask.  `dist` is `knn_mean_dist(points)` when the caller has it already."""
    N = points.shape[0]
    if N > capacity:
        raise ValueError(f"{N} points exceed the capacity {capacity}")
    rng = np.random.default_rng(cfg.seed)
    if dist is None:
        dist = knn_mean_dist(points)
    # isolated outliers get knn distances orders of magnitude above the bulk:
    # cap at 10x the median
    dist = np.minimum(dist, 10.0 * max(float(np.median(dist)), 1e-7))
    scales = np.log(np.clip(dist * cfg.init_scale, 1e-7, None))[:, None].repeat(3, axis=1)
    K = (cfg.sh_degree + 1) ** 2
    sh0 = ((rgbs - 0.5) / SH_C0)[:, None, :]
    shN = np.zeros((N, K - 1, 3), np.float32)
    quats = rng.random((N, 4), dtype=np.float32)
    opac = np.full(N, math.log(cfg.init_opacity / (1 - cfg.init_opacity)), np.float32)

    def pad(x):
        tail = np.zeros((capacity - N,) + x.shape[1:], x.dtype)
        return np.concatenate([x, tail])

    # padding slots get identity quats
    quats_pad = np.concatenate(
        [quats, np.tile(np.array([1, 0, 0, 0], np.float32), (capacity - N, 1))]
    )
    arrays = {
        "means": pad(points.astype(np.float32)), "quats": quats_pad,
        "scales": pad(scales.astype(np.float32)), "opacities": pad(opac),
        "sh0": pad(sh0.astype(np.float32)), "shN": pad(shN),
    }
    params = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    alive = torch.from_numpy(np.arange(capacity) < N).to(device)
    return params, alive


class Trainer:
    """Holds the model, the optimizer state and the data; `train()` runs the
    loop, one `run_step` per step.  `train_step` and `update` are usable on
    their own."""

    # local scale axes the default strategy tests and samples; the surfel
    # trainer passes (0, 1)
    strategy_scale_axes: Tuple[int, ...] = (0, 1, 2)

    def __init__(self, cfg: Config, data: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None):
        if cfg.strategy not in ("default", "mcmc"):
            raise ValueError(f"strategy must be 'default' or 'mcmc', got {cfg.strategy!r}")
        if cfg.data != "npz":
            raise NotImplementedError(
                f"data {cfg.data!r}: only 'npz' is ported (the COLMAP loader is ROADMAP "
                "Queue 1 item 12)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        os.makedirs(cfg.result_dir, exist_ok=True)

        if data is None:
            path = cfg.data_dir or os.environ.get("GSPLAT_TPU_TEST_DATA", "")
            if not path:
                raise ValueError("pass the data arrays, or name the .npz in Config.data_dir")
            with np.load(path) as d:
                data = {k: d[k] for k in d.files}
        self.height, self.width = int(data["height"]), int(data["width"])
        self.viewmats = np.asarray(data["viewmats"], np.float32)
        self.Ks = np.asarray(data["Ks"], np.float32)
        self._full_points = np.asarray(data["means3d"], np.float32)
        self._full_rgbs = (np.asarray(data["colors"]) / 255.0).astype(np.float32)
        sub = max(cfg.npz_subsample, 1)
        points, rgbs = self._full_points[::sub], self._full_rgbs[::sub]
        # no photographs: train views 0..V-2 against rendered targets, eval view V-1
        self.train_views = list(range(len(self.viewmats) - 1))
        self.eval_views = [len(self.viewmats) - 1]
        centers = np.linalg.inv(self.viewmats)[:, :3, 3]
        self.scene_scale = float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1

        if cfg.strategy == "mcmc":
            self.strategy = MCMCStrategy(
                cap_max=cfg.cap_max, refine_every=cfg.refine_every,
                noise_injection_stop_iter=cfg.mcmc_noise_stop,
            )
            self.strategy_state = self.strategy.initialize_state(self.device)
            self.capacity = cfg.cap_max
        else:
            self.capacity = cfg.capacity or int(len(points) * 6)
            self.strategy = DefaultStrategy(
                refine_every=cfg.refine_every, grow_grad2d=cfg.grow_grad2d,
                scale_axes=self.strategy_scale_axes,
            )
            self.strategy_state = self.strategy.initialize_state(
                self.capacity, scene_scale=self.scene_scale, device=self.device)
        # the neighbour search over the full cloud runs once: the initial
        # scales and the targets share it when nothing is subsampled
        self._full_dist = knn_mean_dist(self._full_points)
        self.params, self.alive = create_splats(
            points, rgbs, self.capacity, cfg, self.device,
            dist=self._full_dist if sub == 1 else None,
        )
        self.opt_state = adam_init(self.params)
        self.strategy.check_sanity(self.params, (self.opt_state.mu, self.opt_state.nu))
        self.start_step = 0
        if cfg.ckpt:
            self._load(cfg.ckpt)

        bs_scale = math.sqrt(cfg.batch_size)
        self.lrs = {
            "means": cfg.means_lr * self.scene_scale * bs_scale,
            "scales": cfg.scales_lr * bs_scale,
            "opacities": cfg.opacities_lr * bs_scale,
            "quats": cfg.quats_lr * bs_scale,
            "sh0": cfg.sh0_lr * bs_scale,
            "shN": cfg.shN_lr * bs_scale,
        }

    # ------------------------------------------------------------------ render

    def render(self, params, alive, viewmats, Ks, sh_degree, offset=None, absgrad=False):
        op = torch.where(alive, torch.sigmoid(params["opacities"]), 0.0)
        colors = torch.cat([params["sh0"], params["shN"]], dim=1)
        return rasterization(
            params["means"], params["quats"], torch.exp(params["scales"]), op, colors,
            viewmats, Ks, self.width, self.height, sh_degree=sh_degree,
            near_plane=self.cfg.near_plane, far_plane=self.cfg.far_plane,
            isect_capacity=self.cfg.isect_capacity,
            row_capacity=self.cfg.row_capacity or None,
            means2d_offset=offset, absgrad=absgrad,
        )

    @property
    def absgrad(self) -> bool:
        """The default strategy can ask for AbsGS screen gradients."""
        return isinstance(self.strategy, DefaultStrategy) and self.strategy.absgrad

    def loss_fn(self, params, alive, viewmats, Ks, pixels, sh_degree, offset=None, step=0):
        """The training loss and the render's meta."""
        cfg = self.cfg
        colors, _, meta = self.render(params, alive, viewmats, Ks, sh_degree, offset=offset,
                                      absgrad=self.absgrad)
        colors = torch.clamp(colors, 0.0, 1.0)
        loss = l1_loss(colors, pixels) * (1.0 - cfg.ssim_lambda)
        loss = loss + ssim_loss(colors, pixels) * cfg.ssim_lambda
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * torch.mean(
                torch.where(alive, torch.sigmoid(params["opacities"]), 0.0))
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * torch.mean(
                torch.where(alive[:, None], torch.exp(params["scales"]), 0.0))
        return loss, meta

    def train_step(self, params, alive, viewmats, Ks, pixels, sh_degree: int, step: int = 0):
        """One forward and backward.  Returns (loss, gradients keyed like
        params, screen-space gradient [C, cap, 2], radii, visibility [cap],
        isect_overflow)."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        offset = torch.zeros((viewmats.shape[0], self.capacity, 2), dtype=torch.float32,
                             device=self.device, requires_grad=True)
        loss, meta = self.loss_fn(leaves, alive, viewmats, Ks, pixels, sh_degree, offset=offset,
                                  step=step)
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        radii = meta["radii"]
        visibility = (radii > 0).all(dim=-1).any(dim=0) & alive
        return loss.detach(), grads, offset.grad, radii, visibility, meta["isect_overflow"]

    def update(self, params, opt_state: AdamState, grads, visibility, lr_scale_means: float):
        """Clip (if configured) and take the selective Adam step, in place."""
        clip = float(self.cfg.grad_clip)
        if clip > 0.0:
            gnorm = torch.sqrt(sum(torch.sum(g**2) for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        lrs_t = dict(self.lrs)
        lrs_t["means"] = self.lrs["means"] * lr_scale_means
        return selective_adam_update(params, grads, opt_state, lrs_t, visibility=visibility)

    # ------------------------------------------------------------------- train

    def sh_degree_at(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.sh_degree)

    def run_step(self, step: int, view_ids: np.ndarray, viewmats, Ks, pixels) -> Dict[str, Any]:
        """One whole training step on the views `view_ids` of the train set
        (`viewmats`, `Ks`, `pixels` hold every train view): forward, backward,
        Adam, then the strategy: the default strategy's statistics, refine and
        opacity reset, or MCMC's refine and noise.  Updates the model and the
        optimizer state; returns {step, view, sh_degree, refined, reset,
        noised} and `loss` and `overflow` as tensors, which the step does not
        wait for."""
        sh_degree = self.sh_degree_at(step)
        idx = torch.from_numpy(view_ids).to(self.device)
        loss, grads, g_screen, radii, visibility, overflow = self.train_step(
            self.params, self.alive, viewmats[idx], Ks[idx], pixels[idx], sh_degree, step=step
        )
        lr_scale = exponential_lr(step, 1.0, self.cfg.max_steps)
        self.params, self.opt_state = self.update(self.params, self.opt_state, grads,
                                                  visibility, lr_scale)
        del grads
        moments = (self.opt_state.mu, self.opt_state.nu)
        refined = self.strategy.should_refine(step)
        reset = noised = False
        if isinstance(self.strategy, DefaultStrategy):
            self.strategy.update_state(self.strategy_state, g_screen, radii, self.width,
                                       self.height, len(view_ids))
            if refined:
                self.params, moments, self.alive, _ = self.strategy.refine(
                    self.params, moments, self.alive, self.strategy_state, step, self.generator)
            reset = self.strategy.should_reset_opa(step)
            if reset:
                self.params, moments = self.strategy.reset_opa(self.params, moments)
        else:
            if refined:
                self.params, moments, self.alive = self.strategy.refine(
                    self.params, moments, self.alive, self.strategy_state, self.generator)
            noised = self.strategy.should_inject_noise(step)
            if noised:
                self.params = self.strategy.inject_noise(
                    self.params, self.alive, self.lrs["means"] * lr_scale, self.generator)
        self.opt_state = self.opt_state._replace(mu=moments[0], nu=moments[1])
        return dict(step=step, view=int(view_ids[0]), sh_degree=sh_degree, loss=loss,
                    overflow=overflow, refined=refined, reset=reset, noised=noised)

    def train(self, targets: Optional[torch.Tensor] = None):
        """Run steps start_step..max_steps-1.  `targets` are the training
        images of every view when the caller rendered them already
        (`_make_npz_targets`)."""
        cfg = self.cfg
        C = cfg.batch_size
        dev = self.device
        targets_all = self._make_npz_targets() if targets is None else targets
        targets = targets_all[: len(self.train_views)]
        heldout = (
            targets_all[len(self.train_views):],
            torch.from_numpy(self.viewmats[self.eval_views]).to(dev),
            torch.from_numpy(self.Ks[self.eval_views]).to(dev),
        )
        viewmats_all = torch.from_numpy(self.viewmats[self.train_views]).to(dev)
        Ks_all = torch.from_numpy(self.Ks[self.train_views]).to(dev)
        n_train = viewmats_all.shape[0]

        rng = np.random.default_rng(cfg.seed)
        overflow_steps = 0
        t0 = time.time()
        for step in range(self.start_step, cfg.max_steps):
            if cfg.fixed_batch:
                idx = (np.arange(C, dtype=np.int64) + step * C) % n_train
            else:
                idx = rng.integers(0, n_train, C)
            out = self.run_step(step, idx, viewmats_all, Ks_all, targets)
            if step % 100 == 0:  # the only steps that wait for the card
                if bool(out["overflow"]):
                    overflow_steps += 1
                    print(f"WARNING step {step}: intersection capacity overflow: splats "
                          f"truncated; raise isect_capacity (now {cfg.isect_capacity})",
                          flush=True)
                print(f"step {step}: loss {float(out['loss']):.4f} n_gs "
                      f"{int(self.alive.sum())} ({time.time() - t0:.0f}s)", flush=True)
            if (step + 1) % cfg.eval_every == 0 or step == cfg.max_steps - 1:
                self.eval(step, targets, viewmats_all, Ks_all, tag="train")
                self.eval(step, *heldout, tag="heldout")
            if (step + 1) % cfg.save_every == 0 or step == cfg.max_steps - 1:
                self._save(step)
        if overflow_steps:
            print(f"NOTE: {overflow_steps} of the steps checked hit isect-capacity overflow",
                  flush=True)
        return self.params, self.alive

    def target_splats(self) -> Tuple[torch.Tensor, ...]:
        """(means, quats, scales, opacities, colors) of the full point cloud
        as the targets render it: scales from knn distances, identity quats,
        flat 0.9 opacity, point colours."""
        dev = self.device
        n = len(self._full_points)
        scales = np.clip(self._full_dist, 1e-4, None)[:, None].repeat(3, 1).astype(np.float32)
        quats = torch.zeros((n, 4), device=dev)
        quats[:, 0] = 1.0
        return (torch.from_numpy(self._full_points).to(dev), quats,
                torch.from_numpy(scales).to(dev), torch.full((n,), 0.9, device=dev),
                torch.from_numpy(self._full_rgbs).to(dev))

    @torch.no_grad()
    def _make_npz_targets(self) -> torch.Tensor:
        """Targets: a clean render of the full point cloud (`target_splats`)
        at every camera."""
        dev = self.device
        args = self.target_splats()
        outs = []
        chunk = max(self.cfg.batch_size, 1)
        for i in range(0, len(self.viewmats), chunk):
            c, _, meta = rasterization(
                *args, torch.from_numpy(self.viewmats[i : i + chunk]).to(dev),
                torch.from_numpy(self.Ks[i : i + chunk]).to(dev), self.width, self.height,
                isect_capacity=self.cfg.isect_capacity,
                row_capacity=self.cfg.row_capacity or None,
            )
            if bool(meta["isect_overflow"]):
                raise RuntimeError(
                    f"target render overflowed isect_capacity={self.cfg.isect_capacity} "
                    f"at views [{i}, {i + chunk})"
                )
            outs.append(torch.clamp(c, 0.0, 1.0))
        return torch.cat(outs, dim=0)

    @torch.no_grad()
    def eval(self, step: int, targets, viewmats, Ks, tag: str = "eval") -> float:
        """PSNR of the current model over the given views."""
        sh_degree = self.sh_degree_at(step)
        chunk = max(self.cfg.batch_size, 1)
        outs = []
        for i in range(0, len(viewmats), chunk):
            c, _, meta = self.render(self.params, self.alive, viewmats[i : i + chunk],
                                     Ks[i : i + chunk], sh_degree)
            if bool(meta["isect_overflow"]):
                print(f"WARNING eval[{tag}] @{step}: isect overflow in views "
                      f"[{i},{i + chunk}): metrics underestimate", flush=True)
            outs.append(c)
        colors = torch.clamp(torch.cat(outs, dim=0), 0.0, 1.0)
        mse = torch.mean((colors - targets) ** 2)
        psnr = float(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))
        print(f"eval[{tag}] @{step}: PSNR {psnr:.2f}", flush=True)
        stats = {"step": step, "tag": tag, "psnr": psnr, "n_gs": int(self.alive.sum())}
        with open(os.path.join(self.cfg.result_dir, "stats.jsonl"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        return psnr

    # -------------------------------------------------------------- checkpoint

    def _save(self, step: int) -> str:
        """Full-state checkpoint in the JAX trainer's layout, the strategy's
        state included.  `key` and `pose_deltas` are written only so that its
        loader accepts the file; this trainer keeps neither."""
        out = os.path.join(self.cfg.result_dir, f"ckpt_{step}.npz")
        flat = train_state_to_numpy(self.params, self.alive, self.opt_state,
                                    self.strategy_state)
        flat["step"] = np.asarray(step)
        flat["key"] = np.array([0, self.cfg.seed & 0xFFFFFFFF], np.uint32)
        flat["pose_deltas"] = np.zeros((len(self.train_views), 9), np.float32)
        np.savez(out, **flat)
        print(f"saved {out}", flush=True)
        return out

    def _load(self, path: str) -> None:
        """Resume from a checkpoint of this trainer or of the JAX trainer."""
        with np.load(path) as d:
            flat = {k: d[k] for k in d.files}
        state = train_state_from_numpy(flat, device=self.device)
        if state.alive.shape[0] != self.capacity:
            raise ValueError(f"{path}: capacity {state.alive.shape[0]} != {self.capacity}")
        self.params, self.alive, self.opt_state = state.params, state.alive, state.opt_state
        # the strategy's own entries, as the JAX trainer restores them
        for k in self.strategy_state:
            if k in state.strategy_state:
                self.strategy_state[k] = state.strategy_state[k]
        self.start_step = int(flat["step"]) + 1
        print(f"resumed from {path} at step {self.start_step}", flush=True)


def config_from_args(argv=None, config_cls=Config) -> Tuple[Config, Optional[str]]:
    """Parse `[default|mcmc] --device D --field value ...` into (config,
    device); the mcmc command gets the regularizers it needs (0.01 each)
    unless set."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("strategy", choices=["default", "mcmc"], nargs="?", default="default")
    p.add_argument("--device", default=None, help="the card unless 'cpu'")
    for f in dataclasses.fields(config_cls):
        if f.name == "strategy":
            continue
        t = type(f.default)
        if t is bool:
            t = lambda v: str(v).lower() in ("1", "true", "yes", "on")
        p.add_argument(f"--{f.name}", type=t, default=f.default)
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    cfg = config_cls(**args)
    if cfg.strategy == "mcmc":
        if cfg.opacity_reg == 0.0:
            cfg.opacity_reg = 0.01
        if cfg.scale_reg == 0.0:
            cfg.scale_reg = 0.01
    return cfg, device
