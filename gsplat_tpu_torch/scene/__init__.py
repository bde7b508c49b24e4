from .components import GaussianScene, Scene, Stage
from .convert import load_checkpoint, splats_from_numpy
from .inference import GaussianInferenceScene, render_scene

__all__ = [
    "GaussianInferenceScene",
    "GaussianScene",
    "Scene",
    "Stage",
    "load_checkpoint",
    "render_scene",
    "splats_from_numpy",
]
