"""DynamicStrategy: deformation-aware densification.

Port of `gsplat_tpu/contrib/dynamic/strategy.py`: the default strategy plus
a per-gaussian `dynamic_mask` in its state.  Parameters are
capacity-padded with an `alive` mask, so the mask never reallocates; list
"dynamic_mask" in `sidecar_state_keys` and duplicate / split copy each
parent's flag into its child's slot.  The HexPlane and deform-network
parameters are not per-gaussian and live in their own optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ...strategy.default import DefaultStrategy


@dataclasses.dataclass(frozen=True)
class DynamicStrategy(DefaultStrategy):
    """DefaultStrategy with dynamic_mask bookkeeping."""

    def initialize_state(self, cap: int, scene_scale: float = 1.0,
                         device=None) -> Dict[str, Any]:
        state = super().initialize_state(cap, scene_scale, device=device)
        state["dynamic_mask"] = torch.zeros(cap, dtype=torch.bool, device=device)
        return state
