"""The 3DGS configurations on the program: the trainer for a "train" mix,
the Stage with an inference scene for a "serve" mix.

Each session builds the program's objects once from the seed, runs one unit
of work per `unit(i)` call (the same call in set-up and in the window),
and after the window judges what the timed path produced against
reference/, which gets the same seeded inputs and works everything else out
again.  The program is imported here only, at set-up.
"""

from __future__ import annotations

import gc
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import scene as scene_mod
from ..harness import traffic
from ..reference import splat3d, train3d

UNITS_PLANNED = 100_000  # views drawn for the order; a window takes a few thousand at most
SEED_POINTS = 64  # the trainer's own start, which the scene overwrites
ADAM_B1 = 0.9  # the trainer's Adam: mu = (1 - b1) g after one step from zero
CONTROL_PAYLOAD = (torch.float8_e4m3fn, torch.float8_e5m2)


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _render_kw(cfg: dict, train: bool = False) -> dict:
    """near, far and radius_clip of a render: the trainer's renders take
    rasterization's default radius_clip (`train_radius_clip`)."""
    kw = {k: cfg[k] for k in ("near_plane", "far_plane", "radius_clip")}
    if train:
        kw["radius_clip"] = cfg["train_radius_clip"]
    return kw


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def open_session(cfg: dict, mix: dict, check: dict, seed: int, device, traced: bool = False):
    """`check`: the cell's checks/<cell>.json.  `traced`: the window is the
    mix's traced units (the serve check's sample is drawn from those)."""
    if mix["kind"] == "train":
        return TrainSession(cfg, mix, check, seed, device)
    if mix["kind"] == "serve":
        return ServeSession(cfg, mix, check, seed, device, traced)
    raise ValueError(f"the 3DGS configurations take train or serve mixes, not {mix['kind']!r}")


def _build_kernels(device) -> None:
    if torch.device(device).type == "cuda":
        from gsplat_tpu_torch import _build

        _build.build_all()


class TrainSession:
    """The trainer resumed at `cfg["window_first_step"]` on the seeded
    scene: set-up sizes its capacities and runs the mix's checked steps
    through `unit`, keeping what the check reads (each step's loss, the
    first gradient from Adam's first moment, each leaf's change).

    The trainer is built on a few of the scene's points, at the
    configuration's capacity (`cap_max` for MCMC, `capacity` for the
    default strategy), and the scene is copied into its rows: its own
    initialisation (a neighbour search on the host) would be overwritten."""

    @staticmethod
    def trainer_classes():
        from gsplat_tpu_torch.trainer import Config, Trainer

        return Config, Trainer

    def __init__(self, cfg: dict, mix: dict, check: dict, seed: int, device):
        Config, Trainer = self.trainer_classes()
        _build_kernels(device)
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.n_check, self.check = check["check_steps"], check
        params = scene_mod.make_scene(cfg, seed, device)
        self.cams = traffic.cameras(mix, params["means"])
        self.targets = traffic.targets(mix, mix["views"], scene_mod.generator(seed + 1, device),
                                       device)
        self.order = traffic.order(mix["views"], UNITS_PLANNED, seed)
        self.first_step = cfg["window_first_step"]
        colors = (params["sh0"][:, 0] * scene_mod.SH_C0 + 0.5) * 255.0
        V = mix["views"]
        data = dict(means3d=params["means"][:SEED_POINTS].cpu().numpy(),
                    colors=colors[:SEED_POINTS].cpu().numpy(),
                    viewmats=self.cams.viewmats.cpu().numpy(),
                    Ks=np.tile(self.cams.K.cpu().numpy()[None], (V, 1, 1)),
                    width=mix["width"], height=mix["height"])
        # the trainer makes its result directory; nothing in the window writes there
        self.result_dir = tempfile.mkdtemp(prefix="gsplat-bench-")
        tcfg = Config(**cfg["trainer"], result_dir=self.result_dir, seed=seed % (1 << 63),
                      near_plane=cfg["near_plane"], far_plane=cfg["far_plane"])
        _log("train: scene, cameras and targets made; building the trainer")
        self.tr = Trainer(tcfg, data=data, device=device)
        _log("train: trainer built; sizing the capacity")
        self.n = params["means"].shape[0]
        if self.tr.capacity < self.n:
            raise ValueError(f"the trainer's capacity {self.tr.capacity} is under the scene's "
                             f"{self.n} gaussians")
        for k, v in cfg["strategy_fields"].items():
            if getattr(self.tr.strategy, k) != v:
                raise ValueError(f"the program's {type(self.tr.strategy).__name__}.{k} is "
                                 f"{getattr(self.tr.strategy, k)!r}, the configuration's {v!r}")
        with torch.no_grad():  # the scene in the first rows; any further rows stay dead
            for k, v in params.items():
                self.tr.params[k][: self.n].copy_(v)
            self.tr.alive.copy_(torch.arange(len(self.tr.alive), device=device) < self.n)
        self.rows = self._check_rows(params)
        del params, data
        self.view_ids = np.zeros(1, np.int64)
        self.Ks = self.cams.K[None]
        self._size_capacity()
        _free()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self._checked_steps()

    def _size_capacity(self) -> None:
        """The intersection and row capacity: a pass that may overflow gives
        each view's box count, a second the exact count; the most over the
        views, with the mix's headroom for the model's growth."""
        tr, cfg = self.tr, self.tr.cfg

        def count(cap):
            cfg.isect_capacity = cfg.row_capacity = cap
            need = 0
            for v in range(len(self.cams.viewmats)):
                with torch.no_grad():
                    meta = tr.render(tr.params, tr.alive, self.cams.viewmats[v:v + 1], self.Ks,
                                     tr.cfg.sh_degree)[2]
                n_vis = int((meta["radii"] > 0).all(dim=-1).sum())
                n = (int(meta["tiles_per_gauss"].sum()) if bool(meta["isect_overflow"])
                     else int(meta["n_isects"]))
                need = max(need, n + n_vis)
            return need

        cap = count(count(1 << 16) + 4096)
        cfg.isect_capacity = cfg.row_capacity = int(cap * self.mix["capacity_headroom"]) + 4096
        _log(f"train: {cap} slots at most over the views; capacity {cfg.isect_capacity}")

    def _check_rows(self, params) -> Dict[str, torch.Tensor]:
        """Named row sets [n] bool over which the check also takes the first
        gradient's norms (`<name>.<leaf>`); none here."""
        return {}

    def unit(self, i: int):
        """Step first_step + i on the i-th view of the order: the loader's
        decode of its target, then run_step (which does not wait)."""
        v = self.order[i]
        pixels = traffic.decode(self.targets[v:v + 1])
        out = self.tr.run_step(self.first_step + i, self.view_ids,
                               self.cams.viewmats[v:v + 1], self.Ks, pixels)
        return out["loss"], out["overflow"]

    def _checked_steps(self) -> None:
        n = self.n_check
        outs = [self.unit(0)]
        _sync(self.device)
        mu = self.tr.opt_state.mu
        norm = lambda m: float(torch.linalg.vector_norm(m, dtype=torch.float64)) / (1 - ADAM_B1)
        self.first_grad = {k: norm(m) for k, m in mu.items()}
        for name, rows in self.rows.items():
            self.first_grad.update({f"{name}.{k}": norm(m[: self.n][rows]) for k, m in mu.items()})
        outs += [self.unit(i) for i in range(1, n)]
        _sync(self.device)
        self.losses = [float(loss) for loss, _ in outs]
        start = scene_mod.make_scene(self.cfg, self.seed, self.device)
        self.change = {k: float(torch.linalg.vector_norm(self.tr.params[k][: self.n] - start[k],
                                                         dtype=torch.float64))
                       for k in start}
        del start  # back to the allocator's cache, which the window reuses
        gc.collect()
        self.done = n
        _log(f"train: checked steps done, losses {self.losses}")

    @staticmethod
    def failed(outs) -> int:
        if not outs:
            return 0
        loss = torch.stack([o[0] for o in outs])
        overflow = torch.stack([torch.as_tensor(o[1]).reshape(()) for o in outs])
        return int((overflow.to(loss.device) | ~torch.isfinite(loss)).sum())

    def close(self) -> None:
        self.tr = None
        shutil.rmtree(self.result_dir, ignore_errors=True)
        _free()

    def _scene_scale(self) -> float:
        """The trainer's: 1.1 times the cameras' largest distance from their
        mean centre."""
        centers = np.linalg.inv(self.cams.viewmats.cpu().numpy())[:, :3, 3]
        return float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1

    def _lrs(self) -> Dict[str, float]:
        t = self.cfg["trainer"]
        lrs = {k: t[f"{k}_lr"] for k in train3d.LEAVES}
        lrs["means"] *= self._scene_scale()
        return lrs

    def _hyper(self) -> train3d.Hyper:
        t, m, sf = self.cfg["trainer"], self.mix, self.cfg["strategy_fields"]
        return train3d.Hyper(self._lrs(), t["max_steps"], t["ssim_lambda"], t["opacity_reg"],
                             t["scale_reg"], sf["noise_lr"], sf["noise_opacity_t"],
                             sf["noise_opacity_k"],
                             self.cfg["sh_degree"], _render_kw(self.cfg, train=True), m["width"],
                             m["height"])

    def _noise(self):
        """The MCMC noise as the trainer draws it: one standard normal
        [N, 3] a step from a generator on the device seeded as its own."""
        g = scene_mod.generator(self.seed % (1 << 63), self.device)
        return lambda: torch.randn((self.n, 3), generator=g, device=self.device)

    reference_step = staticmethod(train3d.train_step)

    def _follow(self, payload, half_rows: bool = False):
        params = scene_mod.make_scene(self.cfg, self.seed, self.device)
        alive = torch.ones(self.n, dtype=torch.bool, device=self.device)
        k = self.n_check
        views = [(self.cams.viewmats[self.order[i]], self.cams.K) for i in range(k)]
        targets = [lambda v=self.order[i]: traffic.decode(self.targets[v]) for i in range(k)]
        steps = [self.first_step + i for i in range(k)]
        with torch.backends.cudnn.flags(allow_tf32=False):
            hp = self._hyper()._replace(half_rows=half_rows)
            out = train3d.follow(params, alive, steps, views, targets, hp, self._noise(),
                                 payload, self.reference_step)
        del params
        _free()
        return out

    def readings(self) -> Dict[str, float]:
        """The program's checked steps against the reference's."""
        return _gaps((self.losses, self.first_grad, self.change), self._follow(None))

    control_payload = CONTROL_PAYLOAD

    def control(self) -> Dict[str, float]:
        """The reference in the precision below the configuration's, against
        the reference."""
        return _gaps(self._follow(self.control_payload), self._follow(None))

    def fault(self) -> Dict[str, float]:
        """The reference with half of the image left out of the loss (the
        mean taken over the rest), against the reference."""
        return _gaps(self._follow(None, half_rows=True), self._follow(None))

    def count(self, params, viewmat) -> dict:
        """The work of one view on the reference."""
        _, _, live, vis = splat3d.render(params, viewmat, self.cams.K, self.mix["width"],
                                         self.mix["height"], _render_kw(self.cfg, True),
                                         self.cfg["sh_degree"])
        return dict(model="3dgs", live=live, visible=vis, channels=3)

    def work(self, units: List[int]) -> List[dict]:
        """Per traced unit, counted on the reference over the scene as made."""
        return _work(self, [self.order[i] for i in units])


def _grad_gaps(g1, g0, keys) -> List[float]:
    """Each leaf's gap between its norm and the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    med = statistics.median(g0[k] for k in keys)
    return [abs(g1[k] - g0[k]) / max(g0[k], med) for k in keys]


def _gaps(got, want) -> Dict[str, float]:
    """loss_gap: the largest |loss - reference| / reference over the
    checked steps.  grad_gap and change_gap: the worst leaf's gap
    (`_grad_gaps`); leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of change_gap (they move by round-off
    alone).  grad_gap_median: the median leaf's gap.  grad_gap_<name>: the
    worst leaf's gap over the session's named rows (`_check_rows`)."""
    (l1, g1, d1), (l0, g0, d0) = got, want
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    leaves = [k for k in g0 if "." not in k]
    g_med = statistics.median(g0[k] for k in leaves)
    d_med = statistics.median(d0.values())
    grad = _grad_gaps(g1, g0, leaves)
    moved = [k for k in d0 if g0[k] >= 1e-3 * g_med]
    change_gap = max(abs(d1[k] - d0[k]) / max(d0[k], d_med) for k in moved)
    out = {"loss_gap": loss_gap, "grad_gap": max(grad),
           "grad_gap_median": statistics.median(grad), "change_gap": change_gap}
    for name in sorted({k.split(".")[0] for k in g0 if "." in k}):
        keys = [k for k in g0 if k.startswith(name + ".")]
        out[f"grad_gap_{name}"] = max(_grad_gaps(g1, g0, keys))
    return out


def _work(sess, views) -> List[dict]:
    """`sess.count` of each view, over the scene as made; the gaussians and
    pixels beside."""
    params = scene_mod.make_scene(sess.cfg, sess.seed, sess.device)
    n = params["means"].shape[0]
    cache: Dict[int, dict] = {}
    for v in views:
        if v not in cache:
            cache[v] = dict(sess.count(params, sess.cams.viewmats[v]), gaussians=n,
                            pixels=sess.mix["width"] * sess.mix["height"])
    del params
    _free()
    return [cache[v] for v in views]


class ServeSession:
    """The seeded scene as a GaussianInferenceScene on a Stage, rendered at
    render_scene's default (the fast path).  Set-up sizes the capacity over
    every pose and renders each once; the check's sample of requests (drawn
    from the seed) is kept as it completes."""

    def __init__(self, cfg: dict, mix: dict, check: dict, seed: int, device,
                 traced: bool = False):
        from gsplat_tpu_torch.scene import (GaussianInferenceScene, GaussianScene, Stage,
                                            render_scene)

        _build_kernels(device)
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        params = scene_mod.make_scene(cfg, seed, device)
        self.cams = traffic.cameras(mix, params["means"])
        self.order = traffic.order(mix["azimuths"], UNITS_PLANNED, seed)
        gscene = GaussianScene("grid", params)
        scene = GaussianInferenceScene.from_gaussian_scene(gscene, id="grid")
        gscene.splats = {}  # a server keeps the inference scene only
        del params
        self.stage = Stage()
        self.stage.add_scene(gscene, lambda splats, alive=None, **kw: render_scene(scene, **kw))
        self.kw = dict(K=self.cams.K, width=mix["width"], height=mix["height"],
                       tile_size=cfg["tile_size"], **_render_kw(cfg))
        self._size_capacity()
        rng = np.random.default_rng(seed)
        pool = mix["trace_units"] if traced else check["sample_from"]
        self.sample = sorted(int(i) for i in rng.choice(pool, check["check_requests"],
                                                        replace=False))
        self.kept: Dict[int, tuple] = {}
        on_card = self.device.type == "cuda"
        H, W = mix["height"], mix["width"]
        # untraced, the sample goes to pinned host buffers; traced, the few
        # sampled images stay on the card, so that no copy enters the trace
        self.host = None if traced else [(torch.empty(1, H, W, 3, pin_memory=on_card),
                                          torch.empty(1, H, W, 1, pin_memory=on_card))
                                         for _ in self.sample]
        self.copy_stream = torch.cuda.Stream() if on_card and not traced else None
        _free()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for p in range(mix["azimuths"]):  # warm every pose at the sized capacity
            self.request(p)
        _sync(self.device)
        self.done = 0
        _log("serve: every pose warmed")

    def request(self, pose: int):
        return self.stage.render("grid", viewmat=self.cams.viewmats[pose],
                                 isect_capacity=self.cap, row_capacity=self.cap, **self.kw)

    def _size_capacity(self) -> None:
        """The capacity, from the fast path's own counts over every pose:
        the most intersections, plus one slot a visible gaussian and 4096.
        A pass starts at four slots a gaussian; where a pose overflows, its
        count may have lost the rows past the capacity, so the next pass has
        at least twice the capacity, until one overflows at no pose."""
        self.cap = 4 * self.cfg["n_gaussians"]
        while True:
            need, over = 0, False
            for p in range(self.mix["azimuths"]):
                _, _, meta = self.request(p)
                n_vis = int((meta["radii"] > 0).all(dim=-1).sum())
                need = max(need, int(meta["n_isects"]) + n_vis)
                over |= bool(meta["isect_overflow"])
            if not over:
                break
            self.cap = max(2 * self.cap, need + 4096)
        self.cap = need + 4096
        _log(f"serve: {need} slots at most over the poses; capacity {self.cap}")

    def unit(self, i: int):
        img, alpha, meta = self.request(self.order[i])
        if i in self.sample:
            if self.host is None:  # traced: held on the card, read after the trace
                self.kept[i] = (img, alpha)
            elif self.copy_stream is None:
                img_h, alpha_h = self.host[self.sample.index(i)]
                img_h.copy_(img), alpha_h.copy_(alpha)
                self.kept[i] = (img_h, alpha_h)
            else:  # to the host on a side stream, out of the request's way
                img_h, alpha_h = self.host[self.sample.index(i)]
                s = self.copy_stream
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    img_h.copy_(img, non_blocking=True)
                    alpha_h.copy_(alpha, non_blocking=True)
                img.record_stream(s), alpha.record_stream(s)
                self.kept[i] = (img_h, alpha_h)
        return meta["isect_overflow"]

    @staticmethod
    def failed(outs) -> int:
        if not outs:
            return 0
        return int(torch.stack([torch.as_tensor(o).reshape(()) for o in outs]).sum())

    def close(self) -> None:
        _sync(self.device)
        self.stage = None
        _free()

    def _compare(self, payload) -> Dict[str, float]:
        """Worst over the sample: the mean |rgb - reference|, its 99.9th
        percentile and the mean |alpha - reference|; `payload` None judges
        the kept requests, else the reference at that payload."""
        params = scene_mod.make_scene(self.cfg, self.seed, self.device)
        out = {"rgb_mean_gap": 0.0, "rgb_p999_gap": 0.0, "alpha_mean_gap": 0.0}
        if len(self.kept) < len(self.sample):
            return {k: float("inf") for k in out}
        for i in self.sample:
            pose = self.order[i]
            args = (params, self.cams.viewmats[pose], self.cams.K, self.mix["width"],
                    self.mix["height"], _render_kw(self.cfg), self.cfg["sh_degree"])
            ref, ref_a, _, _ = splat3d.render(*args)
            if payload is None:
                img, alpha = (t.to(self.device)[0] for t in self.kept[i])
            else:
                img, alpha, _, _ = splat3d.render(*args, payload=payload)
            d = (img - ref).abs().flatten()
            k = max(1, int(round(0.999 * d.numel())))
            out["rgb_mean_gap"] = max(out["rgb_mean_gap"], float(d.mean()))
            out["rgb_p999_gap"] = max(out["rgb_p999_gap"], float(d.kthvalue(k).values))
            out["alpha_mean_gap"] = max(out["alpha_mean_gap"],
                                        float((alpha.reshape(ref_a.shape) - ref_a).abs().mean()))
            del ref, ref_a, img, alpha, d
        del params
        _free()
        return out

    def readings(self) -> Dict[str, float]:
        return self._compare(None)

    def control(self) -> Dict[str, float]:
        return self._compare(CONTROL_PAYLOAD)

    def count(self, params, viewmat) -> dict:
        _, _, live, vis = splat3d.render(params, viewmat, self.cams.K, self.mix["width"],
                                         self.mix["height"], _render_kw(self.cfg),
                                         self.cfg["sh_degree"])
        return dict(model="3dgs", live=live, visible=vis, channels=3)

    def work(self, units: List[int]) -> List[dict]:
        return _work(self, [self.order[i] for i in units])
