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
`addons_to_numpy` / `addons_from_numpy` do the same for the trainer's
add-ons, under the JAX trainer's keys (examples/simple_trainer.py:_save,
_load): `pose_deltas`, `bil_grids`, the appearance head's `app_*` with its
Adam moments `amu_*`, `anu_*` and `app_opt_count`, PPISP's `isp_*`, `imu_*`,
`inu_*` and `ppisp_opt_count`; the appearance features ride with the
parameters as `p_features`.  `hexplane_from_numpy` and
`deform_params_from_numpy` carry the dynamic trainer's HexPlane and deform
network parameters (contrib/dynamic) across.
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


def addons_to_numpy(pose_deltas: Optional[torch.Tensor] = None,
                    bil_grids: Optional[torch.Tensor] = None,
                    app_params: Optional[Mapping[str, torch.Tensor]] = None,
                    app_opt_state: Optional[AdamState] = None,
                    ppisp_params: Optional[Mapping[str, torch.Tensor]] = None,
                    ppisp_opt_state: Optional[AdamState] = None) -> Dict[str, np.ndarray]:
    """The trainer's add-ons in the JAX checkpoint's flat layout; None
    leaves an add-on out."""
    np_ = lambda v: v.detach().cpu().numpy()
    flat: Dict[str, np.ndarray] = {}
    if pose_deltas is not None:
        flat["pose_deltas"] = np_(pose_deltas)
    if bil_grids is not None:
        flat["bil_grids"] = np_(bil_grids)
    for params, state, p, m, v, count in (
            (app_params, app_opt_state, "app_", "amu_", "anu_", "app_opt_count"),
            (ppisp_params, ppisp_opt_state, "isp_", "imu_", "inu_", "ppisp_opt_count")):
        if params is None:
            continue
        flat[count] = np_(state.count)
        for k, x in params.items():
            flat[p + k], flat[m + k], flat[v + k] = np_(x), np_(state.mu[k]), np_(state.nu[k])
    return flat


def addons_from_numpy(flat: Mapping[str, np.ndarray], *,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The add-ons a flat checkpoint holds, on `device` (the card by
    default): "pose_deltas" and "bil_grids" tensors, "app" and "ppisp"
    (params, AdamState) pairs."""
    dev = resolve_device(device)
    to = lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
    out: Dict[str, Any] = {k: to(flat[k]) for k in ("pose_deltas", "bil_grids") if k in flat}
    for name, p, m, v, count in (("app", "app_", "amu_", "anu_", "app_opt_count"),
                                 ("ppisp", "isp_", "imu_", "inu_", "ppisp_opt_count")):
        params = {k[len(p):]: to(x) for k, x in flat.items() if k.startswith(p) and k != count}
        if not params:
            continue
        zero = adam_init(params)
        mu = {k: to(flat[m + k]) if m + k in flat else zero.mu[k] for k in params}
        nu = {k: to(flat[v + k]) if v + k in flat else zero.nu[k] for k in params}
        n = torch.tensor(int(flat[count]) if count in flat else 0, dtype=torch.int32, device=dev)
        out[name] = (params, AdamState(mu=mu, nu=nu, count=n))
    return out


def hexplane_from_numpy(params: Mapping[str, Any], *, device: DeviceLike = None) -> Dict[str, Any]:
    """A HexPlane parameter dict of the JAX package (contrib/dynamic/
    hexplane.py:hexplane_init, arrays as numpy or anything np.asarray
    reads) as the port's, on `device` (the card by default): the grids and
    the AABB as float32 tensors, the static entries as they are."""
    dev = resolve_device(device)
    to = lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
    out = dict(params)
    out["grids"] = [[to(p) for p in scale] for scale in params["grids"]]
    out["aabb"] = to(params["aabb"])
    out["coo_combs"] = [tuple(int(c) for c in comb) for comb in params["coo_combs"]]
    return out


def deform_params_from_numpy(params: Mapping[str, Any], *,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """The deform network's parameters of the JAX package (contrib/dynamic/
    deformation.py:deform_network_init: {'trunk': [{'w', 'b'}], 'pos',
    'quat', 'opacity'}) as float32 tensors on `device` (the card by
    default)."""
    dev = resolve_device(device)
    to = lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
    out = {"trunk": [{k: to(v) for k, v in layer.items()} for layer in params["trunk"]]}
    for head in ("pos", "quat", "opacity"):
        out[head] = {k: to(v) for k, v in params[head].items()}
    return out
