from .components import GaussianScene, Scene, Stage
from .convert import (
    TrainState,
    load_checkpoint,
    splats_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from .inference import GaussianInferenceScene, render_scene

__all__ = [
    "GaussianInferenceScene",
    "GaussianScene",
    "Scene",
    "Stage",
    "TrainState",
    "load_checkpoint",
    "render_scene",
    "splats_from_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
]
