"""Where the time of a training step with the trainer's add-ons goes, on
the card.

The centre cell of chip_smoke.py's synthetic scene (111,785 points, the
COLMAP phases' points) trains at 3840x2160 from 9 look-at views (8 training
views; the npz branch: the targets are renders of the same points), placed
around the cell ("cell") and then, as the COLMAP phases place them, around
the whole 5x5 grid of cells ("grid", where the cell is small), and last
through the COLMAP branch on chip_smoke.py's written COLMAP scene
("colmap": the same cell and grid cameras, the targets photographs of the
whole grid, the scene normalised by the parser), with
the default strategy and the packed payload and gradients, as phases 16
and 17 of chip_smoke.py do.  It times 8 steps with no add-on, with each of
`pose_opt`, `app_opt`, `bilateral_grid` and `ppisp` alone, and with all
four (host clock around `Trainer.run_step`, ending in a synchronize; the
first two steps are warm-up), then traces 3 steps with none and with all
four under torch.profiler: device time by operator and by kernel, and the
device's idle share.  One JSON object a line.

    python3 studies/addon_step.py        # one H100, about 5 minutes with the build
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gsplat_tpu_torch import _build  # noqa: E402
from gsplat_tpu_torch import trainer as trainer_mod  # noqa: E402

DEVICE = "cuda"
W, H = cs.SERVE_WH
N_POINTS = cs.N_CELL
N_VIEWS = 9
STEPS = 8
WARM = 2
CONFIGS = {
    "none": {},
    "pose_opt": dict(pose_opt=True),
    "app_opt": dict(app_opt=True),
    "bilateral_grid": dict(bilateral_grid=True),
    "ppisp": dict(ppisp=True),
    "all": dict(pose_opt=True, app_opt=True, bilateral_grid=True, ppisp=True),
}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_trainer(data, result_dir: str, cap: int, **flags):
    """A trainer on npz-like `data`, or on the COLMAP scene in the
    directory `data` names."""
    colmap = dict(data="colmap", data_dir=data, factor=1) if isinstance(data, str) else {}
    cfg = trainer_mod.Config(
        result_dir=result_dir, max_steps=1000, sh_degree_interval=cs.TRAIN_SH_INTERVAL,
        fixed_batch=True, seed=cs.SEED, tb_every=0, isect_capacity=cap, row_capacity=cap,
        **colmap, **flags)
    return trainer_mod.Trainer(cfg, data=None if colmap else data, device=DEVICE)


def run_steps(tr, vms, Ks, targets, n: int, first: int = 0):
    """The ms of each of n steps and the peak GiB (None on the CPU)."""
    dev = tr.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ms = []
    for step in range(first, first + n):
        cs.sync(dev)
        t = time.perf_counter()
        tr.run_step(step, np.array([step % len(vms)]), vms, Ks, targets)
        cs.sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, torch.cuda.max_memory_allocated() / 2**30 if on_card else None


def trace(tr, vms, Ks, targets, name: str, n: int = 3) -> None:
    """Device time by operator (self time) and by kernel over n steps, and
    the idle share of their host-clock span."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(STEPS, STEPS + n):
            tr.run_step(step, np.array([step % len(vms)]), vms, Ks, targets)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us, reach = 0.0, -float("inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
    log({"config": name, "traced_ms_per_step": span_ms / n,
         "device_busy_ms_per_step": busy_us / 1e3 / n,
         "device_idle_share": 1.0 - busy_us / 1e3 / span_ms,
         "kernel_launches_per_step": len(kernels) / n})
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in ops[:12]:
        log({"config": name, "op": e.key[:90], "self_device_ms_per_step":
             e.self_device_time_total / 1e3 / n, "calls_per_step": e.count / n,
             "cpu_ms_per_step": e.self_cpu_time_total / 1e3 / n})
    by_kernel = collections.defaultdict(float)
    for e in kernels:
        by_kernel[e.name] += e.time_range.elapsed_us() / 1e3 / n
    for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log({"config": name, "kernel": k[:100], "ms_per_step": ms})


def main() -> int:
    if not torch.cuda.is_available():
        print("addon_step: no CUDA device", file=sys.stderr)
        return 1
    log({"device": torch.cuda.get_device_name(0), "torch": torch.__version__})
    t = time.perf_counter()
    _build.build_all()
    log({"build_s": time.perf_counter() - t})
    study()
    return 0


def study() -> None:
    """Every configuration's steps, and the traces, on DEVICE (the trace on
    the card only), with each camera placement."""
    grid = cs.make_splats(N_POINTS, cs.GRID, cs.SEED)
    c = cs.GRID * cs.GRID // 2  # the centre cell, offset 0: the COLMAP phases' points
    raw = {k: v[c * N_POINTS:(c + 1) * N_POINTS] for k, v in grid.items()}
    for cameras, around in (("cell", raw), ("grid", grid)):
        viewmats, K = cs.look_at_cameras(around["means"], N_VIEWS, W, H)
        study_cameras(cameras, cs.training_data(raw, viewmats, K, (W, H)))
    colmap_dir = tempfile.mkdtemp(prefix="addon_step_colmap_")
    cs.write_colmap_scene(torch.device(DEVICE), grid, N_POINTS, cs.GRID, (W, H), colmap_dir,
                          lambda m: log({"colmap": m}))
    study_cameras("colmap", colmap_dir)


def study_cameras(cameras: str, data) -> None:
    """Each configuration's steps on `data` (npz-like arrays, or a COLMAP
    scene's directory)."""
    tmp = tempfile.mkdtemp(prefix="addon_step_")
    tr = make_trainer(data, os.path.join(tmp, "none"), 1 << 24)
    cap = cs.size_training_capacities(tr, lambda m: log({"sizing": m}))
    n_train = len(tr.train_views)
    targets = tr.colmap_targets() if tr.parser is not None else tr._make_npz_targets()[:n_train]
    vms = torch.from_numpy(tr.viewmats[tr.train_views]).to(DEVICE)
    Ks = torch.from_numpy(tr.Ks[tr.train_views]).to(DEVICE)
    del tr
    summary = {}
    for name, flags in CONFIGS.items():
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        tr = make_trainer(data, os.path.join(tmp, name), cap, **flags)
        ms, peak = run_steps(tr, vms, Ks, targets, STEPS)
        summary[name] = statistics.median(ms[WARM:])
        log({"cameras": cameras, "config": name, "step_ms": ms, "median_ms": summary[name],
             "peak_gib": peak, "capacity": tr.capacity, "gaussians": int(tr.alive.sum())})
        if (name in ("none", "all") or cameras == "colmap") and DEVICE == "cuda":
            trace(tr, vms, Ks, targets, f"{cameras}/{name}")
        del tr
    log({"cameras": cameras, "median_ms_by_config": summary,
         "added_ms": {k: v - summary["none"] for k, v in summary.items()}})


if __name__ == "__main__":
    sys.exit(main())
