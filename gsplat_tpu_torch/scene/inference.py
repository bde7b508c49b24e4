"""GaussianInferenceScene: inference-only scenes and render_scene().

Port of `gsplat_tpu/scene/inference.py`: a scene built from a training
scene (activations applied: normalize / exp / sigmoid) or from tensors that
are activated already (with the activation checks), stored with quats,
scales and opacities in bf16, means in f32 and colors in f32 or, with
`sh_compression="16b"`, in bf16; rendered without autograd, by default
through the fast path (`rasterization(fast=True)`: the bf16-pair packed
payload, about 2^-9 per field).  `release()` drops the tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..utils.trace import trace_function, trace_range
from .components import GaussianScene, Scene

_SH_COMPRESSION = ("none", "16b")


class GaussianInferenceScene(Scene):
    """Activation-applied, inference-only gaussian scene."""

    def __init__(self, id: str, params: Dict[str, torch.Tensor], sh_degree: Optional[int],
                 sh_compression: str = "none"):
        self.id = id
        self._params: Optional[Dict[str, torch.Tensor]] = params
        self.sh_degree = sh_degree
        self.sh_compression = sh_compression

    def put(self, name: str, component: Any) -> None:
        raise TypeError("GaussianInferenceScene is immutable after build")

    def get(self, name: str) -> torch.Tensor:
        if self._params is None:
            raise ValueError(f"scene {self.id!r} has been released")
        return self._params[name]

    @property
    def is_empty(self) -> bool:
        return self._params is None

    def release(self) -> None:
        """Drop the scene's tensors (gaussian_inference_scene.release)."""
        self._params = None

    @property
    def num_gaussians(self) -> int:
        return self.get("means").shape[0]

    @classmethod
    def from_gaussian_scene(cls, scene: GaussianScene, *, id: str,
                            sh_compression: str = "none") -> "GaussianInferenceScene":
        """Build from a raw training scene, applying normalize / exp /
        sigmoid.  Only the rows where `scene.alive` is set are kept."""
        splats = scene.splats
        if "features" in splats:
            raise ValueError("appearance-optimized scenes are not supported; bake RGB and "
                             "use from_gaussian_tensors")
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
        return cls._build(f32(splats["means"]), quats, scales, opacities, colors, sh_degree,
                          sh_compression, id)

    @classmethod
    def from_gaussian_tensors(cls, means, quats, scales, opacities, colors,
                              sh_degree: Optional[int], sh_compression: str = "none", *,
                              id: str, device: DeviceLike = None) -> "GaussianInferenceScene":
        """Build from activated tensors (unit quats, positive scales,
        opacities in [0, 1]), checking those contracts.  Tensors stay on
        their device; arrays go to `device`, the card unless named."""
        if device is None and isinstance(means, torch.Tensor):
            dev = means.device
        else:
            dev = resolve_device(device)
        t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        means, quats, scales, opacities, colors = map(t, (means, quats, scales, opacities, colors))
        if means.dim() != 2 or means.shape[-1] != 3:
            raise ValueError(f"means must be [N, 3], got {tuple(means.shape)}")
        if not bool((scales > 0).all()):
            raise ValueError("scales must be positive (apply exp first)")
        if not bool(((opacities >= 0) & (opacities <= 1)).all()):
            raise ValueError("opacities must be in [0, 1] (apply sigmoid first)")
        qn = torch.linalg.vector_norm(quats, dim=-1)
        if not torch.allclose(qn, torch.ones_like(qn), atol=1e-3):
            raise ValueError("quats must be unit-norm (wxyz)")
        if sh_degree is not None and sh_degree >= 0:
            expected = (sh_degree + 1) ** 2
            if colors.dim() != 3 or colors.shape[1] != expected:
                raise ValueError(f"sh_degree={sh_degree} requires colors [N, {expected}, 3]")
        return cls._build(means, quats, scales, opacities, colors, sh_degree, sh_compression, id)

    @classmethod
    def _build(cls, means, quats, scales, opacities, colors, sh_degree, sh_compression,
               id) -> "GaussianInferenceScene":
        if sh_compression not in _SH_COMPRESSION:
            raise ValueError(f"sh_compression must be one of {_SH_COMPRESSION}, got "
                             f"{sh_compression!r}")
        half = torch.bfloat16
        params = dict(
            means=means,  # f32: world positions keep their full mantissa
            quats=quats.to(half),
            scales=scales.to(half),
            opacities=opacities.to(half),
            colors=colors.to(half) if sh_compression == "16b" else colors,
        )
        return cls(id, params, sh_degree, sh_compression)


@torch.no_grad()
@trace_function("serve.request")
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

    The stored bf16 fields are read as they are (rasterization widens them
    where its route computes in f32).  `fast=True`
    (the default) renders RGB through the bf16-pair packed path, about 2^-9
    per field; the depth modes always take the exact path, as in the JAX
    package.  A released scene raises.
    """
    from ..rendering import rasterization

    if render_mode != "RGB":
        fast = False  # the fast path is color-only
    if not isinstance(scene, GaussianInferenceScene):
        raise TypeError(f"render_scene requires a GaussianInferenceScene; got {type(scene).__name__}")
    if scene.is_empty:
        raise ValueError(f"scene {scene.id!r} has been released")
    dev = scene.get("means").device
    with trace_range("project"):
        viewmat = torch.as_tensor(viewmat, dtype=torch.float32, device=dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        if viewmat.dim() == 2:
            viewmat = viewmat[None]
        if K.dim() == 2:
            K = K[None]

    # the stored tensors go in as they are: the one-pass projection reads
    # bf16 fields itself, and the differentiable route widens them to f32
    g = scene.get
    render, alphas, meta = rasterization(
        g("means"), g("quats"), g("scales"), g("opacities"), g("colors"), viewmat, K, width,
        height, sh_degree=scene.sh_degree, render_mode=render_mode, backgrounds=backgrounds,
        fast=fast, **kwargs,
    )
    meta["render_path"] = "inference"
    return render, alphas, meta
