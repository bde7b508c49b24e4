"""Deform network and deformation table (G-SHARP dynamic scenes).

Port of `gsplat_tpu/contrib/dynamic/deformation.py`: a ReLU MLP trunk over
HexPlane features with three zero-initialised linear heads giving deltas on
(means, quats, opacities), so that the network at construction is the
identity map; and `DeformationTable`, the per-gaussian dynamic flag whose
prune / duplicate / split follow the strategy's topology edits (numpy, as
in the JAX package).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device


def deform_network_init(
    generator: Optional[torch.Generator],
    feature_dim: int,
    hidden_dim: int = 64,
    num_layers: int = 3,
    device: DeviceLike = None,
) -> Dict:
    """The MLP's parameters on `device` (the card unless named): {'trunk':
    [{'w', 'b'}], 'pos', 'quat', 'opacity'}.  Trunk layers draw U(-1/sqrt(fan
    in), 1/sqrt(fan in)) (torch.nn.Linear's default) from `generator`; the
    heads are zero."""
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    if feature_dim < 1:
        raise ValueError(f"feature_dim must be >= 1, got {feature_dim}")
    dev = resolve_device(device)
    dims = [feature_dim] + [hidden_dim] * num_layers

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * (2 * bound) - bound).to(dev)

    params = {"trunk": []}
    for i in range(num_layers):
        bound = 1.0 / math.sqrt(dims[i])
        params["trunk"].append({"w": uniform((dims[i], dims[i + 1]), bound),
                                "b": uniform((dims[i + 1],), bound)})
    for head, out in (("pos", 3), ("quat", 4), ("opacity", 1)):
        params[head] = {"w": torch.zeros((hidden_dim, out), device=dev),
                        "b": torch.zeros((out,), device=dev)}
    return params


def deform_network_apply(
    params: Dict,
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    opacities: torch.Tensor,  # [N, 1]
    t,  # unused: time enters through plane_features
    plane_features: torch.Tensor,  # [N, feature_dim]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(means + d, quats + d, opacities + d)."""
    h = plane_features
    for layer in params["trunk"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    d_means = h @ params["pos"]["w"] + params["pos"]["b"]
    d_quats = h @ params["quat"]["w"] + params["quat"]["b"]
    d_op = h @ params["opacity"]["w"] + params["opacity"]["b"]
    return means + d_means, quats + d_quats, opacities + d_op


class DeformationTable:
    """Per-gaussian bool flag: which gaussians run through the deform net.
    Children inherit their parent's flag."""

    def __init__(self, num_gaussians: int):
        if num_gaussians < 0:
            raise ValueError("num_gaussians must be >= 0")
        self.mask = np.zeros(num_gaussians, dtype=bool)

    def __len__(self) -> int:
        return int(self.mask.shape[0])

    def set_indices(self, indices, value: bool = True) -> None:
        self.mask[np.asarray(indices)] = value

    def prune(self, keep_mask) -> None:
        keep_mask = np.asarray(keep_mask)
        if keep_mask.shape != self.mask.shape:
            raise ValueError(f"keep_mask shape {keep_mask.shape} != table {self.mask.shape}")
        self.mask = self.mask[keep_mask]

    def duplicate(self, indices) -> None:
        self.mask = np.concatenate([self.mask, self.mask[np.asarray(indices)]])

    def split(self, indices, factor: int = 2) -> None:
        if factor < 1:
            raise ValueError(f"factor must be >= 1, got {factor}")
        indices = np.asarray(indices)
        keep = np.ones(self.mask.shape[0], dtype=bool)
        keep[indices] = False
        children = np.repeat(self.mask[indices], factor)
        self.mask = np.concatenate([self.mask[keep], children])
