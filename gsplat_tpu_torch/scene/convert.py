"""Carry trained weights across from the JAX package's layouts.

`splats_from_numpy` takes the JAX package's parameter dict {means, quats,
scales (log), opacities (logit), sh0, shN} as numpy arrays;
`load_checkpoint` reads the trainer's `.npz` checkpoint (`p_*` parameter
keys and `alive`, as examples/simple_trainer.py writes them).  Both return
a raw-parameter GaussianScene; GaussianInferenceScene.from_gaussian_scene
applies the activations.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
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
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dev)
        for k, v in splats.items()
    }
    alive_t = None
    if alive is not None:
        alive_t = torch.from_numpy(np.asarray(alive, dtype=bool)).to(dev)
    return GaussianScene(scene_id, tensors, alive=alive_t)


def load_checkpoint(path: str, *, device: DeviceLike = None) -> GaussianScene:
    """Read a trainer `.npz` checkpoint into a raw-parameter GaussianScene."""
    dev = resolve_device(device)
    with np.load(path) as d:
        splats = {k[2:]: np.asarray(d[k]) for k in d.files if k.startswith("p_")}
        alive = np.asarray(d["alive"]) if "alive" in d.files else None
    if not splats:
        raise ValueError(f"{path}: no p_* parameter arrays")
    return splats_from_numpy(splats, alive, device=dev, scene_id=os.path.basename(path))
