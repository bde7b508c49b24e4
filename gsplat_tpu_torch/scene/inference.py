"""GaussianInferenceScene: inference-only scenes and render_scene().

Port of `gsplat_tpu/scene/inference.py`: a scene built from a training
scene (activations applied: normalize / exp / sigmoid), stored with quats,
scales and opacities in bf16 and means and colors in f32, and rendered
without autograd.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .components import GaussianScene, Scene


class GaussianInferenceScene(Scene):
    """Activation-applied, inference-only gaussian scene."""

    def __init__(self, id: str, params: Dict[str, torch.Tensor], sh_degree: Optional[int]):
        self.id = id
        self._params = params
        self.sh_degree = sh_degree

    def put(self, name: str, component: Any) -> None:
        raise TypeError("GaussianInferenceScene is immutable after build")

    def get(self, name: str) -> torch.Tensor:
        return self._params[name]

    @property
    def num_gaussians(self) -> int:
        return self.get("means").shape[0]

    @classmethod
    def from_gaussian_scene(cls, scene: GaussianScene, *, id: str) -> "GaussianInferenceScene":
        """Build from a raw training scene, applying normalize / exp /
        sigmoid.  Only the rows where `scene.alive` is set are kept."""
        splats = scene.splats
        if "features" in splats:
            raise ValueError("appearance-optimized scenes are not supported; bake RGB first")
        keep = (lambda x: x[scene.alive]) if scene.alive is not None else (lambda x: x)
        f32 = lambda x: keep(x).to(torch.float32)
        q = f32(splats["quats"])
        quats = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        scales = torch.exp(f32(splats["scales"]))
        opacities = torch.sigmoid(f32(splats["opacities"]))
        colors = splats.get("colors")
        if colors is None:
            sh0 = splats.get("sh0")
            if sh0 is None:
                raise ValueError("scene must contain 'colors' or 'sh0'")
            shN = splats.get("shN")
            colors = torch.cat([sh0, shN], dim=1) if shN is not None else sh0
        colors = f32(colors)
        sh_degree = None
        if colors.dim() == 3:
            k = colors.shape[1]
            w = math.isqrt(k)
            if w * w != k:
                raise ValueError(f"SH basis dim must be a perfect square, got {k}")
            sh_degree = w - 1
        for name, a in (("quats", quats), ("scales", scales), ("opacities", opacities)):
            if not bool(torch.isfinite(a).all()):
                raise ValueError(f"{name} contain NaN/Inf after activation")
        half = torch.bfloat16
        params = dict(
            means=f32(splats["means"]),  # f32: world positions keep their full mantissa
            quats=quats.to(half),
            scales=scales.to(half),
            opacities=opacities.to(half),
            colors=colors,
        )
        return cls(id, params, sh_degree)


@torch.no_grad()
def render_scene(
    scene: GaussianInferenceScene,
    *,
    viewmat,
    K,
    width: int,
    height: int,
    render_mode: str = "RGB",
    backgrounds=None,
    fast: bool = True,
    **kwargs,
):
    """Inference-only render of a scene: (colors [C, H, W, D], alphas
    [C, H, W, 1], meta with meta['render_path'] = 'inference').

    Parameters are unpacked from bf16 to f32 at the boundary.  `fast=True`
    (the bf16-pair packed path) is not ported yet and raises for the color
    mode; depth modes always take the exact path, as in the JAX package.
    """
    from ..rendering import rasterization

    if render_mode != "RGB":
        fast = False  # the fast path is color-only
    if not isinstance(scene, GaussianInferenceScene):
        raise TypeError(f"render_scene requires a GaussianInferenceScene; got {type(scene).__name__}")
    f32 = lambda name: scene.get(name).to(torch.float32)
    dev = scene.get("means").device
    viewmat = torch.as_tensor(viewmat, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    if viewmat.dim() == 2:
        viewmat = viewmat[None]
    if K.dim() == 2:
        K = K[None]
    render, alphas, meta = rasterization(
        f32("means"), f32("quats"), f32("scales"), f32("opacities"), f32("colors"),
        viewmat, K, width, height, sh_degree=scene.sh_degree, render_mode=render_mode,
        backgrounds=backgrounds, fast=fast, **kwargs,
    )
    meta["render_path"] = "inference"
    return render, alphas, meta
