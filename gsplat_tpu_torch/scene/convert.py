"""Carry trained weights across from the JAX package's layouts.

`splats_from_numpy` takes the JAX package's parameter dict {means, quats,
scales (log), opacities (logit), sh0, shN} as numpy arrays;
`load_checkpoint` reads the trainer's `.npz` checkpoint (`p_*` parameter
keys and `alive`, as examples/simple_trainer.py writes them) or its `.ply`
export.  Both return
a raw-parameter GaussianScene; GaussianInferenceScene.from_gaussian_scene
applies the activations.

`train_state_from_numpy` / `train_state_to_numpy` carry a whole training
state (parameters, `alive`, Adam moments and step count, and the strategy's
state) across in the flat layout of that checkpoint (`p_*`, `mu_*`, `nu_*`,
`opt_count`, `alive`, `ss_*`; examples/simple_trainer.py:_save), so a
checkpoint of either trainer loads in the other.  The default strategy's
`scene_scale` is a float in the state and a 0-d array in the file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..exporter import load_ply_to_splats
from ..optimizers.adam import AdamState, adam_init
from .components import GaussianScene


def splats_from_numpy(
    splats: Mapping[str, np.ndarray],
    alive: Optional[np.ndarray] = None,
    *,
    device: DeviceLike = None,
    scene_id: str = "scene",
) -> GaussianScene:
    """A GaussianScene of float32 tensors on `device` (the card by default)."""
    dev = resolve_device(device)
    tensors = {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dev, copy=True)
        for k, v in splats.items()
    }
    alive_t = None
    if alive is not None:
        alive_t = torch.from_numpy(np.asarray(alive, dtype=bool)).to(dev, copy=True)
    return GaussianScene(scene_id, tensors, alive=alive_t)


def load_checkpoint(path: str, *, device: DeviceLike = None) -> GaussianScene:
    """Read a trainer `.npz` checkpoint, or a 3DGS `.ply` (the trainer's
    `save_ply` export), into a raw-parameter GaussianScene: log scales and
    logit opacities, as both files store them; a `.ply` holds only live
    gaussians, so its scene has no `alive` mask."""
    dev = resolve_device(device)
    if path.endswith(".ply"):
        return splats_from_numpy(load_ply_to_splats(path), device=dev,
                                 scene_id=os.path.basename(path))
    with np.load(path) as d:
        splats = {k[2:]: np.asarray(d[k]) for k in d.files if k.startswith("p_")}
        alive = np.asarray(d["alive"]) if "alive" in d.files else None
    if not splats:
        raise ValueError(f"{path}: no p_* parameter arrays")
    return splats_from_numpy(splats, alive, device=dev, scene_id=os.path.basename(path))


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # raw parameters, capacity-padded
    alive: torch.Tensor  # [cap] bool
    opt_state: AdamState
    strategy_state: Dict[str, Any]  # the `ss_*` entries; scene_scale a float


def train_state_from_numpy(flat: Mapping[str, np.ndarray], *, device: DeviceLike = None) -> TrainState:
    """A training state on `device` (the card by default) from the flat
    checkpoint layout.  Missing moments start at zero; a missing `alive`
    means every slot is live."""
    dev = resolve_device(device)
    # always a copy: the trainer updates its tensors in place
    to = lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
    params = {k[2:]: to(v) for k, v in flat.items() if k.startswith("p_")}
    if not params:
        raise ValueError("no p_* parameter arrays")
    zero = adam_init(params)
    mu = {k: to(flat[f"mu_{k}"]) if f"mu_{k}" in flat else zero.mu[k] for k in params}
    nu = {k: to(flat[f"nu_{k}"]) if f"nu_{k}" in flat else zero.nu[k] for k in params}
    count = torch.tensor(int(flat["opt_count"]) if "opt_count" in flat else 0,
                         dtype=torch.int32, device=dev)
    cap = next(iter(params.values())).shape[0]
    alive = (torch.from_numpy(np.array(flat["alive"], dtype=bool)).to(dev)
             if "alive" in flat else torch.ones(cap, dtype=torch.bool, device=dev))
    strategy_state = {
        k[3:]: (float(v) if k == "ss_scene_scale" else torch.from_numpy(np.array(v)).to(dev))
        for k, v in flat.items() if k.startswith("ss_")
    }
    return TrainState(params, alive, AdamState(mu=mu, nu=nu, count=count), strategy_state)


def train_state_to_numpy(params: Mapping[str, torch.Tensor], alive: torch.Tensor,
                         opt_state: AdamState,
                         strategy_state: Optional[Mapping[str, Any]] = None,
                         ) -> Dict[str, np.ndarray]:
    """The flat checkpoint layout of a training state, as numpy arrays; a
    float of the strategy state becomes a 0-d array."""
    flat = {"alive": alive.cpu().numpy(), "opt_count": opt_state.count.cpu().numpy()}
    for k, v in params.items():
        flat[f"p_{k}"] = v.detach().cpu().numpy()
        flat[f"mu_{k}"] = opt_state.mu[k].cpu().numpy()
        flat[f"nu_{k}"] = opt_state.nu[k].cpu().numpy()
    for k, v in (strategy_state or {}).items():
        flat[f"ss_{k}"] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return flat
