"""Capture/replay profiling harness and named rasterization workloads.

Port of `gsplat_tpu/profile.py` (upstream gsplat's profile.py):
`capture_inputs(envvar=...)` snapshots an op's inputs during a real run
and `ProfileWorkload` replays a captured call with input overrides and
timing.  A capture is an .npz of the arrays (tensors and numpy arrays)
and a pickled `.spec`: the `torch.utils._pytree` spec of (args, kwargs)
and the other leaves.  Every array loads back as a tensor on one explicit
device (the card unless named).  A JAX capture pickles a JAX `PyTreeDef`,
which this module cannot read, and the other way round.  Timing
synchronises the device.  The expected-kernel-family check reads the
kernels a `torch.profiler` trace of the call launched
(`compiled_hlo_contains`, named after the JAX function it stands for).

`run_workload` runs the presets "3dgs", "2dgs" and "3dgut" forward and
forward + backward with the losses "sum", "l1" and "l1+ssim" on
`utils.data.synthetic_test_data` (the garden npz of the JAX presets is not
bundled; `data_path` names one):

    python -m gsplat_tpu_torch.profile --workload 3dgs --scene-grid 5 [--device cpu]
"""

from __future__ import annotations

import functools
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ._device import DeviceLike, resolve_device


def capture_inputs(envvar: str, path: Optional[str] = None) -> Callable:
    """Decorator: when `envvar` is set, snapshot the first call's inputs.

    The snapshot goes to $<envvar> (a directory), one capture per decorated
    function, `<name>.capture.npz` and `<name>.capture.spec`.
    """

    def deco(fn: Callable) -> Callable:
        done = {"saved": False}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            target = os.environ.get(envvar, path)
            if target and not done["saved"]:
                os.makedirs(target, exist_ok=True)
                save_inputs(os.path.join(target, f"{fn.__name__}.capture"), args, kwargs)
                done["saved"] = True
            return fn(*args, **kwargs)

        return wrapper

    return deco


def save_inputs(path: str, args: tuple, kwargs: dict) -> None:
    """(args, kwargs) to `path`.npz (every tensor and numpy array) and
    `path`.spec (the pytree spec and the other leaves)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    arrays = {}
    kinds = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            arrays[f"a{i}"] = leaf.detach().cpu().numpy()
            kinds.append(("arr", f"a{i}"))
        elif isinstance(leaf, np.ndarray):
            arrays[f"a{i}"] = leaf
            kinds.append(("arr", f"a{i}"))
        else:
            kinds.append(("obj", leaf))
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".spec", "wb") as f:
        pickle.dump({"spec": kinds, "treespec": pytree.treespec_dumps(spec)}, f)


def load_inputs(path: str, device: DeviceLike = None):
    """(args, kwargs) of a capture, every array as a tensor on `device`."""
    dev = resolve_device(device)
    data = np.load(path + ".npz")
    with open(path + ".spec", "rb") as f:
        meta = pickle.load(f)
    leaves = [torch.from_numpy(data[key]).to(dev) if kind == "arr" else key
              for kind, key in meta["spec"]]
    return pytree.tree_unflatten(leaves, pytree.treespec_loads(meta["treespec"]))


def _sync(tree) -> None:
    """Wait for the devices of the tensors in `tree` (their work so far)."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)


@dataclass
class ProfileWorkload:
    """Replay a captured op with overrides; report timing: load the capture
    onto `device`, apply input overrides, run the forward (and optionally a
    gradient), time it after `warmup` calls."""

    fn: Callable
    capture_path: str
    overrides: Dict[str, Any] = field(default_factory=dict)
    warmup: int = 3
    repeats: int = 10
    device: DeviceLike = None

    def load(self):
        args, kwargs = load_inputs(self.capture_path, self.device)
        kwargs = {**kwargs, **self.overrides}
        return args, kwargs

    def run(self, grad_argnums=None) -> Dict[str, float]:
        args, kwargs = self.load()
        f = self.fn
        if grad_argnums is not None:
            base = self.fn

            def f(*a, **k):
                full = list(a)
                diff = [full[i].detach().requires_grad_(True) for i in grad_argnums]
                for i, d in zip(grad_argnums, diff):
                    full[i] = d
                leaf = pytree.tree_leaves(base(*full, **k))[0]
                return torch.autograd.grad(leaf.sum(), diff)

        for _ in range(self.warmup):
            f(*args, **kwargs)
        _sync(args)  # the device of the inputs runs the calls
        t0 = time.perf_counter()
        for _ in range(self.repeats):
            f(*args, **kwargs)
        _sync(args)
        dt = (time.perf_counter() - t0) / self.repeats
        return {"time_s": dt, "fps": 1.0 / dt if dt > 0 else float("inf")}


def compiled_hlo_contains(fn: Callable, substrings, *args, **kwargs) -> bool:
    """Whether one call of `fn` ran, for each of `substrings`, a kernel whose
    name contains it: the expected-kernel-family check that
    gsplat_tpu.profile.compiled_hlo_contains makes on XLA's compiled HLO,
    here on a torch.profiler trace of the call (the kernels launched on the
    card when any tensor argument lies there, else the CPU's operators)."""
    leaves = pytree.tree_leaves((args, kwargs))
    on_card = any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in leaves)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        _sync((leaves, out))
    kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
    # the program's spans show on the device's timeline as user annotations
    names = {e.name for e in prof.events() if e.device_type == kind and not e.is_user_annotation}
    return all(any(s in n for n in names) for s in substrings)


# ---------------------------------------------------------------------------
# Workload presets + CLI
# ---------------------------------------------------------------------------
#
# Upstream gsplat's named workloads ("3dgs" / "3dgut" / "2dgs") and main():
# each preset builds the scene at a chosen scale and runs the matching
# rasterization path forward and forward + backward, with loss presets.


def _scene_args(scene_grid: int, res_factor: int, data_path: Optional[str], dev):
    from .utils.data import load_test_data, synthetic_test_data

    if data_path is None:
        scene = synthetic_test_data(scene_grid=scene_grid)
    else:
        scene = load_test_data(data_path, scene_grid=scene_grid)
    means, quats, scales, opac, colors, viewmats, Ks, width, height = scene
    Ks = Ks[:1].copy()
    W, H = width // res_factor, height // res_factor
    Ks[:, :2, :] /= res_factor
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(means), t(quats), t(scales), t(opac), t(colors), t(viewmats[:1]), t(Ks), W, H)


def run_workload(
    name: str = "3dgs",
    scene_grid: int = 1,
    res_factor: int = 1,
    backward: bool = True,
    loss: str = "sum",
    isect_capacity: int = 2_000_000,
    repeats: int = 10,
    data_path: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Run a named rasterization workload on `device` (the card unless
    named); returns the mean ms of a forward (`fwd_ms`) and of a forward
    and backward (`step_ms`), each call ending in a read of its loss."""
    from .losses import l1_loss, ssim_loss
    from .rendering import rasterization, rasterization_2dgs

    dev = resolve_device(device)
    means, quats, scales, opac, colors, viewmats, Ks, W, H = _scene_args(
        scene_grid, res_factor, data_path, dev)

    if name == "3dgs":
        def render(m, q, s, o, c):
            return rasterization(m, q, s, o, c, viewmats, Ks, W, H,
                                 isect_capacity=isect_capacity)[0]
    elif name == "2dgs":
        def render(m, q, s, o, c):
            return rasterization_2dgs(m, q, s, o, c, viewmats, Ks, W, H,
                                      isect_capacity=isect_capacity)[0]
    elif name == "3dgut":
        def render(m, q, s, o, c):
            return rasterization(m, q, s, o, c, viewmats, Ks, W, H,
                                 isect_capacity=isect_capacity, with_ut=True,
                                 with_eval3d=True)[0]
    else:
        raise ValueError(f"unknown workload {name!r} (3dgs|2dgs|3dgut)")

    tgt = torch.zeros((1, H, W, 3), device=dev) + 0.4

    def loss_of(img):
        img = torch.clamp(img[..., :3], 0.0, 1.0)
        if loss == "sum":
            return img.sum()
        if loss == "l1":
            return l1_loss(img, tgt)
        if loss == "l1+ssim":
            return 0.8 * l1_loss(img, tgt) + 0.2 * ssim_loss(img, tgt)
        raise ValueError(f"unknown loss {loss!r}")

    rargs = (means, quats, scales, opac, colors)

    def fwd():
        with torch.no_grad():
            return float(loss_of(render(*rargs)))

    out: Dict[str, float] = {}
    fwd()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fwd()
    out["fwd_ms"] = (time.perf_counter() - t0) / repeats * 1e3

    if backward:
        def step():
            diff = [x.detach().requires_grad_(True) for x in rargs]
            grads = torch.autograd.grad(loss_of(render(*diff)), diff)
            return float(grads[0].sum())

        step()
        t0 = time.perf_counter()
        for _ in range(repeats):
            step()
        out["step_ms"] = (time.perf_counter() - t0) / repeats * 1e3
    return out


def main(argv=None):
    """CLI: python -m gsplat_tpu_torch.profile --workload 3dgs --scene-grid 5."""
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="3dgs", choices=["3dgs", "2dgs", "3dgut"])
    p.add_argument("--scene-grid", type=int, default=1)
    p.add_argument("--res-factor", type=int, default=1)
    p.add_argument("--loss", default="sum", choices=["sum", "l1", "l1+ssim"])
    p.add_argument("--no-backward", action="store_true")
    p.add_argument("--isect-capacity", type=int, default=2_000_000)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--data-path", default=None,
                   help="a garden-layout scene npz (default: the synthetic scene)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    res = run_workload(
        a.workload, a.scene_grid, a.res_factor, not a.no_backward, a.loss,
        a.isect_capacity, a.repeats, a.data_path, a.device,
    )
    print(json.dumps({"workload": a.workload, **res}))


if __name__ == "__main__":
    main()
