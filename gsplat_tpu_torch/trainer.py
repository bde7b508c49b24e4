"""The 3DGS trainer: render -> l1 + ssim -> backward -> selective Adam ->
densification strategy (default or MCMC), on a capacity-padded model with an
`alive` mask.

Port of `examples/simple_trainer.py` (Config, knn_mean_dist, create_splats,
Runner.__init__ on its colmap and npz branches with either strategy,
render, make_train_step, make_update_step, train, _make_npz_targets, eval,
render_traj, _save with its `.ply` export, run_compression, _load).  As in
the JAX trainer, `render` (the
training step and the eval) takes the bf16-pair packed sort payload and
packed per-slot gradients by default (`Config.pack_payload`,
`Config.pack_grads`, both True); set both False for the exact float32 path.  The targets are rendered
exactly either way.  The model has a static capacity
(`capacity`, 0 meaning 6x the initial points, for the default strategy;
`cap_max` for MCMC) as in the JAX trainer, so the two compare step by step:
the same seed gives the same initial parameters and the same batch order.

The data is a COLMAP scene (`Config.data="colmap"`, the default, as in
the JAX trainer): `Config.data_dir` holds `sparse/0` (binary or text model)
and `images_{factor}` (or `images`); the views of the `test_every=8`
training split are the targets (datasets/colmap.py), the points of
`points3D` the initial gaussians, and the eval reports PSNR, SSIM, LPIPS
(with `Config.lpips_weights`), the LPIPS proxy, the gaussians, the device
memory and the time on those views.  Or the data is an npz-like mapping
{means3d [N, 3], colors [N, 3] in 0..255, viewmats [V, 4, 4], Ks [V, 3, 3],
width, height}: pass it as `data` (whatever `Config.data` says), or set
`Config.data="npz"` and name a `.npz` file in `Config.data_dir` (or the
GSPLAT_TPU_TEST_DATA environment variable); its targets are clean renders
of the full point cloud and the last view is held out (or, with
`npz_traj_views`, views along a path through the cameras, every
`npz_eval_every`-th held out).  `Config.save_ply`
writes the live gaussians as a 3DGS `.ply` at every save.  The trainer runs
on the card unless `device="cpu"`.

The add-ons of the JAX `Config`, each as the JAX trainer does it:
  * `pose_opt`: per-training-view 9-D pose deltas on the camera-to-world
    matrices (training/pose.py), regularised by `pose_opt_reg`, stepped by
    their own Adam; `pose_noise` perturbs the training poses first;
  * `app_opt`: a per-gaussian `features` leaf [cap, 32] and an appearance
    head whose colours [C, N, 3] = sigmoid(head + sh0) replace the SH
    colours (the eval and the trajectory use the zero embedding);
  * `bilateral_grid`: per-training-view grids of colour affines sliced over
    the raw render (training/bilateral_grid.py), with their TV loss; the
    eval of the training views applies them too;
  * `ppisp`: a learned capture chain on the raw render (training/ppisp.py);
  * `render_traj`: a fly-through of `traj_frames` along `render_traj_path`
    (datasets/traj.py) after training, as PNGs (and an mp4 where imageio
    and its ffmpeg plugin are installed);
  * `compression="png"`: PngCompression of the live gaussians after
    training, into `result_dir/compression`;
  * `tb_every`, `tb_save_image`: TensorBoard scalars (and the target |
    render canvas) under `result_dir/tb` where `tensorboard` is installed.
  * `disable_viewer=False`: the live viewer (viewer/) on `viewer_port`
    during `train()`, as the JAX trainer's: the browser's Pause blocks the
    loop between steps; every 10 steps (and after the last) the trainer
    hands it detached clones of the parameters and the alive mask, under
    `viewer.lock`, so that a frame never reads a tensor a step is writing;
    the frames render on the trainer's device and stream; the server stays
    up after training (`self.viewer`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .compression import PngCompression
from .datasets import Dataset, Parser, encode_png
from .datasets.traj import (
    generate_ellipse_path_z,
    generate_interpolated_path,
    generate_spiral_path,
)
from .exporter import export_splats
from .losses import l1_loss, ssim, ssim_loss
from .optimizers import AdamState, adam_init, adam_update, selective_adam_update
from .rendering import rasterization
from .scene.convert import (
    addons_from_numpy,
    addons_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from .strategy import DefaultStrategy, MCMCStrategy
from .utils.trace import backward_phase, trace_function, trace_range
from .training import (
    apply_appearance,
    apply_pose_deltas,
    apply_ppisp,
    bilateral_slice_image,
    exponential_lr,
    init_appearance,
    init_bilateral_grids,
    init_pose_deltas,
    init_ppisp,
    invert_se3,
    load_lpips_weights,
    lpips,
    lpips_proxy,
    ppisp_regularization,
    total_variation_loss,
)

SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class Config:
    strategy: str = "default"  # "default" | "mcmc"
    data: str = "colmap"  # "colmap" | "npz"; arrays passed as `data=` take the npz branch
    data_dir: str = ""  # the COLMAP scene's directory, or the .npz file
    factor: int = 4  # COLMAP image downsampling: images_{factor}, intrinsics / factor
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
    # bf16-pair packed sort payloads / per-slot gradients in render(), as the
    # JAX trainer's defaults; False for the exact float32 path
    pack_payload: bool = True
    pack_grads: bool = True
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
    lpips_weights: str = ""  # LPIPS(VGG) weights .npz for eval (training/metrics.py)
    save_ply: bool = False  # a .ply of the live gaussians at every save
    # pose optimisation: per-training-view deltas on the camera-to-world matrices
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    pose_noise: float = 0.0  # perturb the training poses (to test pose optimisation)
    # bilateral grids: per-training-view grids of 3x4 colour affines on the renders
    bilateral_grid: bool = False
    bilateral_grid_shape: str = "16,16,8"  # grid X,Y,W
    tv_reg: float = 10.0  # weight of the grids' TV loss
    # a fly-through render after training
    render_traj: bool = False
    render_traj_path: str = "interp"  # raw | interp | ellipse | spiral
    traj_frames: int = 60
    # npz: train on this many views along a path through the cameras (0: the cameras)
    npz_traj_views: int = 0
    npz_eval_every: int = 8  # npz path views: hold out every n-th for the eval
    compression: str = ""  # after training: "" (off) | "png"
    # appearance: per-view embedding and an MLP colour head on a per-gaussian feature
    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    # a learned per-camera ISP on the training renders before the loss
    ppisp: bool = False
    ppisp_lr: float = 1e-3
    ppisp_reg: float = 1e-3
    tb_every: int = 100  # TensorBoard cadence in steps, 0 = off
    tb_save_image: bool = False  # a target | render canvas at each TensorBoard step
    # the live training viewer (viewer/): off by default, as in the JAX trainer
    disable_viewer: bool = True
    viewer_port: int = 8080


APP_FEATURE_DIM = 32  # the appearance head's per-gaussian features
TRAJ_PATHS = ("raw", "interp", "ellipse", "spiral")


def knn_mean_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """Mean distance to the k-1 nearest neighbours (scale init), on the host."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k, workers=-1)
    return d[:, 1:].mean(axis=1)


def create_splats(points: np.ndarray, rgbs: np.ndarray, capacity: int, cfg: Config,
                  device: torch.device, dist: Optional[np.ndarray] = None):
    """Initial gaussian parameters in capacity-padded tensors and the alive
    mask, with the `features` leaf when `cfg.app_opt`.  `dist` is
    `knn_mean_dist(points)` when the caller has it already."""
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
    if cfg.app_opt:  # the appearance head's per-gaussian features
        arrays["features"] = pad(rng.random((N, APP_FEATURE_DIM), dtype=np.float32))
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
        if data is None and cfg.data not in ("colmap", "npz"):
            raise ValueError(f"data must be 'colmap' or 'npz', got {cfg.data!r}")
        if cfg.compression not in ("", "png"):
            raise ValueError(f"unknown compression: {cfg.compression}")
        if cfg.render_traj and cfg.render_traj_path not in TRAJ_PATHS:
            raise ValueError(f"unknown render_traj_path: {cfg.render_traj_path}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        os.makedirs(cfg.result_dir, exist_ok=True)
        self.stats_dir = os.path.join(cfg.result_dir, "stats")
        os.makedirs(self.stats_dir, exist_ok=True)

        self.parser = None
        sub = 1
        if data is None and cfg.data == "colmap":
            self.parser = Parser(cfg.data_dir, factor=cfg.factor, normalize=True, test_every=8)
            self.trainset = Dataset(self.parser, "train")
            self.scene_scale = self.parser.scene_scale * 1.1
            points = self.parser.points
            rgbs = self.parser.points_rgb.astype(np.float32) / 255.0
            self.width, self.height = self.parser.widths[0], self.parser.heights[0]
            if set(self.parser.widths) != {self.width} or set(self.parser.heights) != {self.height}:
                raise ValueError(f"{cfg.data_dir}: the images differ in size; crop or resize "
                                 "them to one size")
            idx = self.trainset.indices
            self.viewmats = np.linalg.inv(self.parser.camtoworlds)[idx].astype(np.float32)
            self.Ks = self.parser.Ks[idx].astype(np.float32)
            self.train_views = list(range(len(idx)))
            self.eval_views = []
        else:
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
            if cfg.npz_traj_views > 0:
                self._npz_path_views()
            else:
                # no photographs: train views 0..V-2 against rendered targets, eval view V-1
                self.train_views = list(range(len(self.viewmats) - 1))
                self.eval_views = [len(self.viewmats) - 1]
            centers = np.linalg.inv(self.viewmats)[:, :3, 3]
            self.scene_scale = float(
                np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1

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
        # npz: the neighbour search over the full cloud runs once, the
        # initial scales and the targets share it when nothing is subsampled
        dist = None
        if self.parser is None:
            self._full_dist = knn_mean_dist(self._full_points)
            dist = self._full_dist if sub == 1 else None
        self.params, self.alive = create_splats(points, rgbs, self.capacity, cfg, self.device,
                                                dist=dist)
        self.opt_state = adam_init(self.params)
        self.strategy.check_sanity(self.params, (self.opt_state.mu, self.opt_state.nu))
        self.start_step = 0
        self._points_np = np.asarray(points)  # the spiral trajectory's bounds
        self._init_addons()
        self.writer = None  # TensorBoard's, open during train()
        self.viewer = None  # the live viewer of train(), with disable_viewer=False
        self.lpips_w = (load_lpips_weights(cfg.lpips_weights, device=self.device)
                        if cfg.lpips_weights and os.path.exists(cfg.lpips_weights) else None)
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
        if cfg.app_opt:
            self.lrs["features"] = cfg.sh0_lr * bs_scale

    def _npz_path_views(self) -> None:
        """npz with `npz_traj_views`: the views along an interpolated path
        through the cameras, every `npz_eval_every`-th held out for the eval;
        reordered [train..., eval...]."""
        cfg = self.cfg
        c2w = np.linalg.inv(self.viewmats)[:, :3, :]
        per_seg = max(cfg.npz_traj_views // max(len(c2w) - 1, 1), 1)
        path = generate_interpolated_path(c2w, per_seg)
        bottom = np.broadcast_to(np.array([0, 0, 0, 1], np.float32), (len(path), 1, 4))
        vm = np.linalg.inv(np.concatenate([path.astype(np.float32), bottom], axis=1))
        vm = vm.astype(np.float32)
        Ks = np.broadcast_to(self.Ks[:1], (len(vm), 3, 3)).copy()
        idx = np.arange(len(vm))
        held = idx % max(cfg.npz_eval_every, 2) == 1
        order = np.concatenate([idx[~held], idx[held]])
        self.viewmats, self.Ks = vm[order], Ks[order]
        n_tr = int((~held).sum())
        self.train_views = list(range(n_tr))
        self.eval_views = list(range(n_tr, len(vm)))

    def _init_addons(self) -> None:
        """The add-ons' parameters and Adam states, as the JAX trainer makes
        them: pose deltas (always, zero), the grids, PPISP (one camera, a
        frame per training view) and the appearance head (from the trainer's
        generator) where switched on."""
        cfg = self.cfg
        dev = self.device
        n_train = len(self.train_views)
        self.pose_deltas = init_pose_deltas(n_train, dev)
        self.pose_opt_state = adam_init({"pose": self.pose_deltas})
        self.pose_perturb = None
        if cfg.pose_noise > 0:
            noise = np.random.default_rng(cfg.seed + 1).normal(0, cfg.pose_noise, (n_train, 9))
            self.pose_perturb = torch.from_numpy(noise.astype(np.float32)).to(dev)
        self.bil_grids = self.bil_opt_state = None
        if cfg.bilateral_grid:
            gx, gy, gw = (int(v) for v in cfg.bilateral_grid_shape.split(","))
            self.bil_grids = init_bilateral_grids(n_train, gx, gy, gw, device=dev)
            self.bil_opt_state = adam_init({"bil": self.bil_grids})
        self.bil_lr = 2e-3 * math.sqrt(cfg.batch_size)
        self.ppisp_params = self.ppisp_opt_state = None
        if cfg.ppisp:
            self.ppisp_params = init_ppisp(num_cameras=1, num_frames=n_train, device=dev)
            self.ppisp_opt_state = adam_init(self.ppisp_params)
        self.app_params = self.app_opt_state = None
        if cfg.app_opt:
            self.app_params = init_appearance(self.generator, n_train, APP_FEATURE_DIM,
                                              embed_dim=cfg.app_embed_dim,
                                              sh_degree=cfg.sh_degree)
            self.app_opt_state = adam_init(self.app_params)

    def addon_params(self) -> Dict[str, Any]:
        """The add-ons switched on, by the name of their gradient: "pose"
        [n_train, 9], "bil" the grids, "app" and "pp" dicts of tensors."""
        cfg = self.cfg
        out: Dict[str, Any] = {}
        if cfg.pose_opt:
            out["pose"] = self.pose_deltas
        if cfg.bilateral_grid:
            out["bil"] = self.bil_grids
        if cfg.app_opt:
            out["app"] = self.app_params
        if cfg.ppisp:
            out["pp"] = self.ppisp_params
        return out

    # ------------------------------------------------------------------ render

    def render(self, params, alive, viewmats, Ks, sh_degree, offset=None, absgrad=False,
               app=None, cam_ids=None):
        """Colours [C, H, W, 3], alphas and meta.  With `app` (the appearance
        head's parameters), the colours are sigmoid(head + sh0) per camera,
        the embeddings of `cam_ids` (None: the zero embedding), not SH."""
        with trace_range("project"):
            op = torch.where(alive, torch.sigmoid(params["opacities"]), 0.0)
            if app is not None:
                cam_pos = invert_se3(viewmats)[:, :3, 3]  # [C, 3]
                dirs = params["means"][None, :, :] - cam_pos[:, None, :]
                adj = apply_appearance(app, params["features"], cam_ids, dirs, sh_degree)
                colors = torch.sigmoid(adj + params["sh0"][None, :, 0, :])  # [C, N, 3]
                sh_degree = None
            else:
                colors = torch.cat([params["sh0"], params["shN"]], dim=1)
            scales = torch.exp(params["scales"])
        return rasterization(
            params["means"], params["quats"], scales, op, colors,
            viewmats, Ks, self.width, self.height, sh_degree=sh_degree,
            near_plane=self.cfg.near_plane, far_plane=self.cfg.far_plane,
            isect_capacity=self.cfg.isect_capacity,
            row_capacity=self.cfg.row_capacity or None,
            means2d_offset=offset, absgrad=absgrad,
            pack_payload=self.cfg.pack_payload, pack_grads=self.cfg.pack_grads,
        )

    @property
    def absgrad(self) -> bool:
        """The default strategy can ask for AbsGS screen gradients."""
        return isinstance(self.strategy, DefaultStrategy) and self.strategy.absgrad

    def loss_fn(self, params, alive, viewmats, Ks, pixels, sh_degree, offset=None, step=0,
                cam_ids=None, addons=None):
        """The training loss and the render's meta.  `addons` (as
        `addon_params` gives them) of the training views `cam_ids`: the pose
        deltas adjust the cameras, the appearance head colours the
        gaussians, the grids and then PPISP map the raw render, each with its
        regulariser."""
        cfg = self.cfg
        addons = addons or {}
        if "pose" in addons:
            with trace_range("project"):
                c2w = apply_pose_deltas(invert_se3(viewmats), addons["pose"][cam_ids])
                viewmats = invert_se3(c2w)
        colors, _, meta = self.render(params, alive, viewmats, Ks, sh_degree, offset=offset,
                                      absgrad=self.absgrad, app=addons.get("app"),
                                      cam_ids=cam_ids)
        with trace_range("loss"):
            if "bil" in addons:
                colors = torch.stack([bilateral_slice_image(g, im)[0]
                                      for g, im in zip(addons["bil"][cam_ids], colors)])
            if "pp" in addons:
                colors = apply_ppisp(addons["pp"], colors, torch.zeros_like(cam_ids), cam_ids)
            colors = torch.clamp(colors, 0.0, 1.0)
            loss = l1_loss(colors, pixels) * (1.0 - cfg.ssim_lambda)
            loss = loss + ssim_loss(colors, pixels) * cfg.ssim_lambda
            if "bil" in addons and cfg.tv_reg > 0:
                loss = loss + cfg.tv_reg * total_variation_loss(addons["bil"])
            if cfg.opacity_reg > 0:
                loss = loss + cfg.opacity_reg * torch.mean(
                    torch.where(alive, torch.sigmoid(params["opacities"]), 0.0))
            if cfg.scale_reg > 0:
                loss = loss + cfg.scale_reg * torch.mean(
                    torch.where(alive[:, None], torch.exp(params["scales"]), 0.0))
            if "pose" in addons and cfg.pose_opt_reg > 0:
                loss = loss + cfg.pose_opt_reg * torch.sum(addons["pose"] ** 2)
            if "app" in addons and cfg.app_opt_reg > 0:
                loss = loss + cfg.app_opt_reg * torch.sum(addons["app"]["embeds"] ** 2)
            if "pp" in addons and cfg.ppisp_reg > 0:
                loss = loss + cfg.ppisp_reg * ppisp_regularization(addons["pp"])
        return loss, meta

    def train_step(self, params, alive, viewmats, Ks, pixels, sh_degree: int, step: int = 0,
                   cam_ids=None, addons=None):
        """One forward and backward.  Returns (loss, gradients keyed like
        params, screen-space gradient [C, cap, 2], radii, visibility [cap],
        isect_overflow); `train_step_addons` returns the add-ons' gradients
        too."""
        return self.train_step_addons(params, alive, viewmats, Ks, pixels, sh_degree, step=step,
                                      cam_ids=cam_ids, addons=addons)[:6]

    def train_step_addons(self, params, alive, viewmats, Ks, pixels, sh_degree: int,
                          step: int = 0, cam_ids=None, addons=None):
        """`train_step` with the add-ons (`addon_params()` unless given) of
        the training views `cam_ids` [C]; returns its six values and the
        add-ons' gradients, keyed as `addons`."""
        addons = self.addon_params() if addons is None else addons
        if addons and cam_ids is None:
            raise ValueError("the add-ons need the training views' cam_ids")
        leaf = lambda v: v.detach().requires_grad_()
        leaves = {k: leaf(v) for k, v in params.items()}
        a_leaves = {name: ({k: leaf(v) for k, v in p.items()} if isinstance(p, dict) else leaf(p))
                    for name, p in addons.items()}
        offset = torch.zeros((viewmats.shape[0], self.capacity, 2), dtype=torch.float32,
                             device=self.device, requires_grad=True)
        kw = dict(cam_ids=cam_ids.long(), addons=a_leaves) if a_leaves else {}
        loss, meta = self.loss_fn(leaves, alive, viewmats, Ks, pixels, sh_degree, offset=offset,
                                  step=step, **kw)
        with trace_range("backward"):
            backward_phase("loss.bwd", loss)
            loss.backward()
        # a leaf the loss does not reach (shN under the appearance head) gets zeros
        grad = lambda v: v.grad if v.grad is not None else torch.zeros_like(v)
        grads = {k: grad(v) for k, v in leaves.items()}
        a_grads = {name: ({k: grad(v) for k, v in p.items()} if isinstance(p, dict) else grad(p))
                   for name, p in a_leaves.items()}
        radii = meta["radii"]
        visibility = (radii > 0).all(dim=-1).any(dim=0) & alive
        return (loss.detach(), grads, offset.grad, radii, visibility, meta["isect_overflow"],
                a_grads)

    @trace_function("optimizer")
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

    @trace_function("optimizer")
    def update_addons(self, grads: Mapping[str, Any]) -> None:
        """One plain Adam step of each add-on in `grads` (as
        `train_step_addons` returns them), in place, at the JAX trainer's
        learning rates."""
        cfg = self.cfg
        if "pose" in grads:
            _, self.pose_opt_state = adam_update({"pose": self.pose_deltas},
                                                 {"pose": grads["pose"]}, self.pose_opt_state,
                                                 cfg.pose_opt_lr)
        if "bil" in grads:
            _, self.bil_opt_state = adam_update({"bil": self.bil_grids}, {"bil": grads["bil"]},
                                                self.bil_opt_state, self.bil_lr)
        if "app" in grads:
            _, self.app_opt_state = adam_update(self.app_params, grads["app"],
                                                self.app_opt_state, cfg.app_opt_lr)
        if "pp" in grads:
            _, self.ppisp_opt_state = adam_update(self.ppisp_params, grads["pp"],
                                                  self.ppisp_opt_state, cfg.ppisp_lr)

    # ------------------------------------------------------------------- train

    def sh_degree_at(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.sh_degree)

    @trace_function("train.step")
    def run_step(self, step: int, view_ids: np.ndarray, viewmats, Ks, pixels) -> Dict[str, Any]:
        """One whole training step on the views `view_ids` of the train set
        (`viewmats`, `Ks`, `pixels` hold every train view): forward, backward,
        Adam (and the add-ons' Adam), then the strategy: the default strategy's statistics, refine and
        opacity reset, or MCMC's refine and noise.  Updates the model and the
        optimizer state; returns {step, view, sh_degree, refined, reset,
        noised} and `loss` and `overflow` as tensors, which the step does not
        wait for."""
        sh_degree = self.sh_degree_at(step)
        idx = torch.from_numpy(view_ids).to(self.device)
        loss, grads, g_screen, radii, visibility, overflow, addon_grads = self.train_step_addons(
            self.params, self.alive, viewmats[idx], Ks[idx], pixels[idx], sh_degree, step=step,
            cam_ids=idx,
        )
        lr_scale = exponential_lr(step, 1.0, self.cfg.max_steps)
        self.params, self.opt_state = self.update(self.params, self.opt_state, grads,
                                                  visibility, lr_scale)
        self.update_addons(addon_grads)
        del grads, addon_grads
        moments = (self.opt_state.mu, self.opt_state.nu)
        refined = self.strategy.should_refine(step)
        reset = noised = False
        with trace_range("strategy"):
            if isinstance(self.strategy, DefaultStrategy):
                self.strategy.update_state(self.strategy_state, g_screen, radii, self.width,
                                           self.height, len(view_ids))
                if refined:
                    self.params, moments, self.alive, _ = self.strategy.refine(
                        self.params, moments, self.alive, self.strategy_state, step,
                        self.generator)
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

    def colmap_targets(self) -> torch.Tensor:
        """The training split's images [V, H, W, 3] in [0, 1], on the device."""
        return torch.from_numpy(
            np.stack([self.trainset[i]["image"] for i in range(len(self.trainset))])
        ).to(self.device)

    def train(self, targets: Optional[torch.Tensor] = None):
        """Run steps start_step..max_steps-1.  `targets` are the training
        images when the caller has them already: of the training split
        (`colmap_targets`), or of every view (`_make_npz_targets`)."""
        cfg = self.cfg
        C = cfg.batch_size
        dev = self.device
        heldout = None
        if self.parser is not None:
            targets = self.colmap_targets() if targets is None else targets
        else:
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
        if self.pose_perturb is not None:
            # corrupt the training poses (the eval's held-out views stay true)
            viewmats_all = invert_se3(apply_pose_deltas(invert_se3(viewmats_all),
                                                        self.pose_perturb))
        grids = self.bil_grids if cfg.bilateral_grid else None

        rng = np.random.default_rng(cfg.seed)
        overflow_steps = 0
        self.writer = self._open_writer()
        self.viewer = None
        if not cfg.disable_viewer:
            self.viewer = self._open_viewer()
        viewer = self.viewer
        t0 = time.time()
        self._train_t0 = t0  # the eval's ellipse_time counts from here
        for step in range(self.start_step, cfg.max_steps):
            if cfg.fixed_batch:
                idx = (np.arange(C, dtype=np.int64) + step * C) % n_train
            else:
                idx = rng.integers(0, n_train, C)
            out = self.run_step(step, idx, viewmats_all, Ks_all, targets)
            if viewer is not None:
                if step % 10 == 0:
                    self._viewer_snapshot()
                viewer.update(step, C * self.width * self.height)
            if step % 100 == 0:  # the only steps that wait for the card
                if bool(out["overflow"]):
                    overflow_steps += 1
                    print(f"WARNING step {step}: intersection capacity overflow: splats "
                          f"truncated; raise isect_capacity (now {cfg.isect_capacity})",
                          flush=True)
                print(f"step {step}: loss {float(out['loss']):.4f} n_gs "
                      f"{int(self.alive.sum())} ({time.time() - t0:.0f}s)", flush=True)
            if self.writer is not None and step % cfg.tb_every == 0:
                self._log_step(step, out, t0, viewmats_all[idx[:1]], Ks_all[idx[:1]],
                               targets[idx[:1]])
            if (step + 1) % cfg.eval_every == 0 or step == cfg.max_steps - 1:
                if heldout is None:  # COLMAP: the training views, as the JAX trainer
                    self.eval(step, targets, viewmats_all, Ks_all, grids=grids)
                else:
                    self.eval(step, targets, viewmats_all, Ks_all, tag="train", grids=grids)
                    self.eval(step, *heldout, tag="heldout")
            if (step + 1) % cfg.save_every == 0 or step == cfg.max_steps - 1:
                self._save(step)
                # the memory and time snapshot of the JAX trainer's save steps
                snap = {"mem": (torch.cuda.memory_allocated(self.device) / 1024**3
                                if self.device.type == "cuda" else 0.0),
                        "ellipse_time": time.time() - t0, "num_GS": int(self.alive.sum())}
                with open(os.path.join(self.stats_dir, f"train_step{step:04d}_rank0.json"),
                          "w") as f:
                    json.dump(snap, f)
        if overflow_steps:
            print(f"NOTE: {overflow_steps} of the steps checked hit isect-capacity overflow",
                  flush=True)
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if viewer is not None:
            self._viewer_snapshot()
            viewer.complete()  # switch to rendering mode; the server stays up
        if cfg.render_traj:
            self.render_traj(step=cfg.max_steps - 1)
        if cfg.compression:
            self.run_compression(cfg.max_steps - 1)
        return self.params, self.alive

    def _open_viewer(self):
        """The live viewer in training mode over the snapshot that
        `_viewer_snapshot` keeps (taken here first)."""
        from .viewer import GsplatViewer, RenderTabState, make_render_fn

        cfg = self.cfg
        self._snapshot = {}
        self._viewer_snapshot()
        snapshot = self._snapshot

        def get_scene():
            p, al = snapshot["params"], snapshot["alive"]
            return {
                "means": p["means"],
                "quats": p["quats"],
                "scales": torch.exp(p["scales"]),
                "opacities": torch.where(al, torch.sigmoid(p["opacities"]), 0.0),
                "colors": torch.cat([p["sh0"], p["shN"]], dim=1),
                "sh_degree": cfg.sh_degree,
                "n_rendered": int(al.sum()),
            }

        return GsplatViewer(
            make_render_fn(get_scene, isect_capacity=cfg.isect_capacity,
                           row_capacity=cfg.row_capacity or None),
            output_dir=cfg.result_dir, mode="training", port=cfg.viewer_port,
            state=RenderTabState(total_gs_count=int(self.params["means"].shape[0]),
                                 max_sh_degree=cfg.sh_degree),
        )

    @torch.no_grad()
    def _viewer_snapshot(self) -> None:
        """Detached clones of the splats and the alive mask for the viewer's
        frames, swapped in under `viewer.lock` (a frame renders under it):
        the optimizer updates the live tensors in place."""
        snap = {"params": {k: self.params[k].detach().clone()
                           for k in ("means", "quats", "scales", "opacities", "sh0", "shN")},
                "alive": self.alive.detach().clone()}
        # the first snapshot comes before the server starts
        with self.viewer.lock if self.viewer is not None else contextlib.nullcontext():
            self._snapshot.update(snap)

    def _open_writer(self):
        """TensorBoard's SummaryWriter under result_dir/tb when tb_every > 0
        and `tensorboard` is installed (else None, with the JAX trainer's
        note)."""
        if self.cfg.tb_every <= 0:
            return None
        if importlib.util.find_spec("tensorboard") is None:
            print("tensorboard unavailable; scalar logs go to stats.jsonl only", flush=True)
            return None
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=os.path.join(self.cfg.result_dir, "tb"))

    def _device_mem_gib(self) -> float:
        """The most device memory this process has held, GiB (0 on the CPU)."""
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 1024**3

    @torch.no_grad()
    def _log_step(self, step: int, out: Mapping[str, Any], t0: float, vm, K, pixels) -> None:
        """The step's TensorBoard scalars, and with tb_save_image the target
        | render canvas of the batch's first view (the updated model, the
        raw render)."""
        w = self.writer
        w.add_scalar("train/loss", float(out["loss"]), step)
        w.add_scalar("train/num_GS", int(self.alive.sum()), step)
        w.add_scalar("train/mem", self._device_mem_gib(), step)
        w.add_scalar("train/steps_per_sec",
                     (step - self.start_step + 1) / max(time.time() - t0, 1e-9), step)
        if self.cfg.tb_save_image:
            colors, _, _ = self.render(self.params, self.alive, vm, K, out["sh_degree"],
                                       app=self.app_params, cam_ids=None)
            canvas = torch.cat([pixels[0], colors[0]], dim=1)
            # scaled as add_image scales floats, but encoded by the port's own
            # PNG writer: add_image needs PIL
            img = (torch.clamp(canvas, 0, 1) * 255.0).to(torch.uint8).cpu().numpy()
            from torch.utils.tensorboard.summary import Summary

            image = Summary.Image(height=img.shape[0], width=img.shape[1], colorspace=3,
                                  encoded_image_string=encode_png(img, level=1))
            w._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag="train/render", image=image)]), step)
        w.flush()

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
    def eval(self, step: int, targets, viewmats, Ks, tag: str = "eval",
             grids=None) -> Tuple[float, float]:
        """PSNR, SSIM, LPIPS (None without weights) and the LPIPS proxy of
        the current model over the given views, with the live gaussians,
        the device memory and the time since training started; written to
        `stats.jsonl`, `stats/{tag}_step{step:04d}.json` and TensorBoard.
        The appearance head takes the zero embedding; `grids`, one per view
        (the training views'), correct the renders.  Returns (psnr, ssim)."""
        sh_degree = self.sh_degree_at(step)
        chunk = max(self.cfg.batch_size, 1)
        outs = []
        for i in range(0, len(viewmats), chunk):
            c, _, meta = self.render(self.params, self.alive, viewmats[i : i + chunk],
                                     Ks[i : i + chunk], sh_degree, app=self.app_params,
                                     cam_ids=None)
            if bool(meta["isect_overflow"]):
                print(f"WARNING eval[{tag}] @{step}: isect overflow in views "
                      f"[{i},{i + chunk}): metrics underestimate", flush=True)
            outs.append(c)
        colors = torch.cat(outs, dim=0)
        if grids is not None:
            colors = torch.stack([bilateral_slice_image(g, im)[0] for g, im in zip(grids, colors)])
        colors = torch.clamp(colors, 0.0, 1.0)
        mse = torch.mean((colors - targets) ** 2)
        psnr = float(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))
        s = float(ssim(colors, targets))
        # the perceptual metrics one view at a time: their features of every
        # view at once would take tens of GiB at 4k; the mean is the same
        views = range(len(colors))
        lp = None
        if self.lpips_w is not None:
            lp = float(torch.cat([lpips(colors[i:i + 1], targets[i:i + 1], self.lpips_w)
                                  for i in views]).mean())
        lp_proxy = float(torch.cat([lpips_proxy(colors[i:i + 1], targets[i:i + 1])
                                    for i in views]).mean())
        print(f"eval[{tag}] @{step}: PSNR {psnr:.2f} SSIM {s:.4f}"
              + (f" LPIPS {lp:.4f}" if lp is not None else "")
              + f" LPIPSproxy {lp_proxy:.4f}", flush=True)
        stats = {"step": step, "tag": tag, "psnr": psnr, "ssim": s, "lpips": lp,
                 "lpips_proxy": lp_proxy, "n_gs": int(self.alive.sum()),
                 # device bytes in use, GiB, as the JAX trainer's _device_mem_gib reads them
                 "mem": (torch.cuda.memory_allocated(self.device) / 1024**3
                         if self.device.type == "cuda" else 0.0),
                 "ellipse_time": (time.time() - self._train_t0
                                  if hasattr(self, "_train_t0") else None)}
        with open(os.path.join(self.cfg.result_dir, "stats.jsonl"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        with open(os.path.join(self.stats_dir, f"{tag}_step{step:04d}.json"), "w") as f:
            json.dump(stats, f)
        if self.writer is not None:
            self.writer.add_scalar(f"{tag}/psnr", psnr, step)
            self.writer.add_scalar(f"{tag}/ssim", s, step)
            self.writer.add_scalar(f"{tag}/lpips_proxy", lp_proxy, step)
            if lp is not None:
                self.writer.add_scalar(f"{tag}/lpips", lp, step)
            self.writer.flush()
        return psnr, s

    @torch.no_grad()
    def render_traj(self, step: Optional[int] = None) -> None:
        """A fly-through of the model along `render_traj_path` through the
        training cameras (`raw`: the cameras; `interp`: a B-spline,
        traj_frames // (cameras - 1) frames a segment; `ellipse`: an orbit at
        the cameras' mean height; `spiral`: bounds from the 0.5 and 99.5
        percentiles of the initial points' distances to the cameras),
        intrinsics of the first camera, written as `traj/NNNN.png` and, where
        imageio and its ffmpeg plugin are installed, `traj.mp4`."""
        cfg = self.cfg
        c2w = invert_se3(torch.from_numpy(self.viewmats)).numpy()[:, :3, :]
        kind = cfg.render_traj_path
        if kind == "raw":
            path = c2w
        elif kind == "interp":
            path = generate_interpolated_path(c2w, max(cfg.traj_frames // max(len(c2w) - 1, 1),
                                                       1))
        elif kind == "ellipse":
            path = generate_ellipse_path_z(c2w, n_frames=cfg.traj_frames,
                                           height=float(c2w[:, 2, 3].mean()))
        elif kind == "spiral":
            cams = c2w[:, :3, 3]
            d = np.linalg.norm(self._points_np[None, :, :] - cams[:, None, :], axis=-1)
            bounds = np.array([np.percentile(d, 0.5), np.percentile(d, 99.5)])
            path = generate_spiral_path(c2w, bounds=bounds, n_frames=cfg.traj_frames)
        else:
            raise ValueError(f"unknown render_traj_path: {kind}")
        bottom = np.tile(np.array([[[0.0, 0, 0, 1.0]]], np.float32), (len(path), 1, 1))
        vm = invert_se3(torch.from_numpy(np.concatenate([path.astype(np.float32), bottom],
                                                        axis=1))).to(self.device)
        K = torch.from_numpy(self.Ks[:1]).to(self.device)
        sh_degree = self.sh_degree_at(step) if step is not None else cfg.sh_degree
        outdir = os.path.join(cfg.result_dir, "traj")
        os.makedirs(outdir, exist_ok=True)
        frames = []
        for i in range(len(path)):
            colors, _, _ = self.render(self.params, self.alive, vm[i : i + 1], K, sh_degree,
                                       app=self.app_params, cam_ids=None)
            img = (torch.clamp(colors[0], 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            with open(os.path.join(outdir, f"{i:04d}.png"), "wb") as f:
                f.write(encode_png(img))
            frames.append(img)
        if importlib.util.find_spec("imageio") and importlib.util.find_spec("imageio_ffmpeg"):
            import imageio

            imageio.mimwrite(os.path.join(cfg.result_dir, "traj.mp4"), frames, fps=30)
        else:
            print("traj video skipped (imageio with its ffmpeg plugin is not installed)",
                  flush=True)
        print(f"wrote {len(frames)} traj frames to {outdir}", flush=True)

    def run_compression(self, step: int) -> Dict[str, float]:
        """PngCompression of the live gaussians into result_dir/compression,
        on the trainer's device; prints the bytes and returns the seconds of
        each part (PngCompression.compress)."""
        keep = self.alive
        splats = {k: self.params[k][keep].detach().cpu().numpy()
                  for k in ("means", "scales", "quats", "opacities", "sh0", "shN")}
        splats["opacities"] = splats["opacities"].reshape(-1)
        cdir = os.path.join(self.cfg.result_dir, "compression")
        seconds = PngCompression(device=self.device).compress(cdir, splats)
        total = sum(os.path.getsize(os.path.join(cdir, f)) for f in os.listdir(cdir))
        print(f"compressed splats -> {cdir} ({total / 1e6:.2f} MB)", flush=True)
        return seconds

    # -------------------------------------------------------------- checkpoint

    def _save(self, step: int) -> str:
        """Full-state checkpoint in the JAX trainer's layout, the strategy's
        state and the add-ons (pose deltas, grids, the appearance head and
        PPISP with their Adam moments) included.  `key` is written only so
        that its loader accepts the file; this trainer keeps none."""
        out = os.path.join(self.cfg.result_dir, f"ckpt_{step}.npz")
        flat = train_state_to_numpy(self.params, self.alive, self.opt_state,
                                    self.strategy_state)
        flat["step"] = np.asarray(step)
        flat["key"] = np.array([0, self.cfg.seed & 0xFFFFFFFF], np.uint32)
        flat.update(addons_to_numpy(self.pose_deltas, self.bil_grids, self.app_params,
                                    self.app_opt_state, self.ppisp_params, self.ppisp_opt_state))
        np.savez(out, **flat)
        print(f"saved {out}", flush=True)
        if self.cfg.save_ply:  # the live gaussians, as the JAX trainer exports them
            ply_dir = os.path.join(self.cfg.result_dir, "ply")
            os.makedirs(ply_dir, exist_ok=True)
            path = os.path.join(ply_dir, f"point_cloud_{step}.ply")
            keep = self.alive
            export_splats(**{k: self.params[k][keep] for k in (
                "means", "scales", "quats", "opacities", "sh0", "shN")}, format="ply", save_to=path)
            print(f"saved {path}", flush=True)
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
        # the add-ons the file holds; the pose and grid Adam states start anew
        addons = addons_from_numpy(flat, device=self.device)
        if "pose_deltas" in addons:
            self.pose_deltas = addons["pose_deltas"]
            self.pose_opt_state = adam_init({"pose": self.pose_deltas})
        if "bil_grids" in addons:
            self.bil_grids = addons["bil_grids"]
            self.bil_opt_state = adam_init({"bil": self.bil_grids})
        if "app" in addons:
            self.app_params, self.app_opt_state = addons["app"]
        if "ppisp" in addons:
            self.ppisp_params, self.ppisp_opt_state = addons["ppisp"]
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
