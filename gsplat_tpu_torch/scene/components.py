"""Scene abstraction: parameter containers with topology hooks.

Port of `gsplat_tpu/scene/components.py`: a minimal abstract scene (`id`,
put/get, topology hooks for strategy ops), a GaussianScene holding the
splat parameter dict and its `alive` mask, and the Stage registry.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional

import torch


class Scene(ABC):
    """Abstract scene contract."""

    id: str

    @abstractmethod
    def put(self, name: str, component: Any) -> None: ...

    @abstractmethod
    def get(self, name: str) -> Any: ...

    # topology hooks (no-op defaults), called by strategy ops
    def on_duplicate(self, sel) -> None: ...

    def on_split(self, sel, rest) -> None: ...

    def on_remove(self, remove_mask) -> None: ...

    def on_relocate(self, dead_indices, sampled_indices) -> None: ...

    def on_sample_add(self, sampled_indices) -> None: ...

    def on_permute(self, order) -> None: ...


class GaussianScene(Scene):
    """Gaussian parameter container.

    `splats` is the parameter dict {means, quats, scales (log), opacities
    (logit), sh0, shN} of tensors (capacity-padded); `alive` is the
    active-slot mask, or None when every slot is live.
    """

    def __init__(
        self,
        scene_id: str,
        splats: Dict[str, torch.Tensor],
        alive: Optional[torch.Tensor] = None,
    ):
        self.id = scene_id
        self.splats = splats
        self.alive = alive
        self._components: Dict[str, Any] = {}

    def put(self, name: str, component: Any) -> None:
        self._components[name] = component

    def get(self, name: str) -> Any:
        return self._components[name]

    def names(self):
        return list(self._components)

    @property
    def num_gaussians(self) -> int:
        if self.alive is not None:
            return int(self.alive.sum())
        return int(next(iter(self.splats.values())).shape[0])


class Stage:
    """scene_id -> (scene, render_fn) registry.

    `render(scene_id, **kwargs)` forwards `splats=scene.splats` (and
    `alive=scene.alive` when set) to the registered render function.
    """

    def __init__(self) -> None:
        self._scenes: Dict[str, tuple] = {}

    def add_scene(self, scene: GaussianScene, render_fn: Callable) -> None:
        if scene.id in self._scenes:
            raise ValueError(f"Scene {scene.id!r} already registered")
        self._scenes[scene.id] = (scene, render_fn)

    def remove_scene(self, scene_id: str) -> None:
        del self._scenes[scene_id]

    def get_scene(self, scene_id: str) -> GaussianScene:
        return self._scenes[scene_id][0]

    def scene_ids(self):
        return list(self._scenes)

    def render(self, scene_id: str, **kwargs):
        scene, fn = self._scenes[scene_id]
        if scene.alive is not None:
            return fn(splats=scene.splats, alive=scene.alive, **kwargs)
        return fn(splats=scene.splats, **kwargs)
