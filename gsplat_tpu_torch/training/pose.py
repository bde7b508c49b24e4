"""Camera pose and appearance optimisation.

Port of `gsplat_tpu/training/pose.py:23-128` (per-camera 9-D pose deltas,
3 translation + a 6-D rotation right-multiplied onto camera-to-world
matrices; the appearance colour head, a per-camera embedding and the view
direction's SH bases beside each gaussian's features through a small MLP),
plus the trainer's differentiable SE(3) inverse
(`examples/simple_trainer.py:198-208`), exact for the similarity poses of a
normalised COLMAP scene too.

Parameters are plain tensors and dicts of tensors, as the JAX package keeps
them, so the trainer differentiates and steps them like the splats.  The
small 3x3 and 4x4 products are written elementwise (no matrix product, so
TF32 never applies); the MLP's layers are matrix products, as in the JAX
package, in float32 (PyTorch's default keeps TF32 off for them).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..ops.sh import eval_sh_bases, num_sh_bases

IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n, k] @ b [..., k, m], as an elementwise product and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def invert_se3(mats: torch.Tensor) -> torch.Tensor:
    """Differentiable inverse of camera transforms [..., 4, 4]:
    [R^T | -R^T t] as the JAX trainer writes it (not a general inverse),
    divided by the square of the block's uniform scale s^2 = |R|_F^2 / 3, so
    that a similarity [s R | t] inverts exactly too.  The COLMAP parser's
    normalised poses are such similarities (its scale stays in the rotation
    block), where the JAX formula moves the camera to t / s^2.  On rigid
    transforms s^2 = 1: the value is the JAX one, and so is the gradient
    along them (s^2 does not change along a rigid motion)."""
    R = mats[..., :3, :3]
    t = mats[..., :3, 3]
    s2 = (R * R).sum(dim=(-2, -1)) / 3.0
    Rt = R.transpose(-1, -2) / s2[..., None, None]
    top = torch.cat([Rt, -(Rt * t[..., None, :]).sum(dim=-1)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mats.dtype, device=mats.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s continuous 6-D rotation -> [..., 3, 3] matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1, keepdim=True), min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def init_pose_deltas(n_cameras: int, device=None) -> torch.Tensor:
    """Zero per-camera pose deltas [n, 9] (3 translation + 6-D rotation)."""
    return torch.zeros((n_cameras, 9), dtype=torch.float32, device=device)


def apply_pose_deltas(camtoworlds: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """camtoworlds [..., 4, 4] @ [R(d6 + I) | dx]: the adjusted poses."""
    dx = deltas[..., :3]
    ident = torch.tensor(IDENTITY_6D, dtype=deltas.dtype, device=deltas.device)
    rot = rotation_6d_to_matrix(deltas[..., 3:] + ident)
    top = torch.cat([rot, dx[..., :, None]], dim=-1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=camtoworlds.dtype,
                          device=camtoworlds.device)
    transform = torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)
    return _matmul_small(camtoworlds, transform)


def init_appearance(generator: torch.Generator, n_cameras: int, feature_dim: int,
                    embed_dim: int = 16, sh_degree: int = 3, mlp_width: int = 64,
                    mlp_depth: int = 2) -> Dict[str, torch.Tensor]:
    """The appearance head's parameters {embeds, w0, b0, w1, b1, ...}, on the
    generator's device: zero embeddings, each layer's weights uniform in
    +-1/sqrt(fan-in) from `generator`, zero biases, and a zero last layer,
    so that the head starts as no adjustment at all."""
    K = num_sh_bases(sh_degree)
    dims = [embed_dim + feature_dim + K] + [mlp_width] * mlp_depth + [3]
    dev = generator.device
    params = {"embeds": torch.zeros((n_cameras, embed_dim), dtype=torch.float32, device=dev)}
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        u = torch.rand((dims[i], dims[i + 1]), generator=generator, dtype=torch.float32,
                       device=dev)
        params[f"w{i}"] = u * (2.0 * bound) - bound
        params[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=torch.float32, device=dev)
    params[f"w{len(dims) - 2}"].zero_()
    return params


def apply_appearance(params: Dict[str, torch.Tensor], features: torch.Tensor,
                     embed_ids: Optional[torch.Tensor], dirs: torch.Tensor,
                     sh_degree: int) -> torch.Tensor:
    """Per-view colour adjustment [C, N, 3] of gaussians with `features`
    [N, F] seen along `dirs` [C, N, 3] by the cameras `embed_ids` [C] (None:
    the zero embedding); SH bases beyond the active degree are zero."""
    C, N = dirs.shape[:2]
    embed_dim = params["embeds"].shape[1]
    if embed_ids is None:
        emb = torch.zeros((C, embed_dim), dtype=torch.float32, device=dirs.device)
    else:
        emb = params["embeds"][embed_ids]
    emb = emb[:, None, :].expand(C, N, embed_dim)
    feats = features[None].expand(C, N, features.shape[-1])
    d = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-8)
    # the basis count: the first layer's fan-in less the other inputs
    K_total = params["w0"].shape[0] - embed_dim - features.shape[-1]
    K_use = min(num_sh_bases(sh_degree), K_total)
    bases = eval_sh_bases(K_use, d)
    if K_use < K_total:
        bases = torch.nn.functional.pad(bases, (0, K_total - K_use))
    h = torch.cat([emb, feats, bases], dim=-1)
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h
