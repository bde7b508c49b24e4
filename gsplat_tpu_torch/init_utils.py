"""Initialization utilities: depth unprojection and the knn scale init.

Port of gsplat_tpu/init_utils.py (:15 multi_frame_depth_unprojection, :68
knn_scale_init), numpy on the host as there (initialization runs once,
before training), with the same seeds and the same order of operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def multi_frame_depth_unprojection(
    images: np.ndarray,  # [N, H, W, 3] (uint8 scaled to [0, 1], float as it is)
    depths: np.ndarray,  # [N, H, W]
    masks: np.ndarray,  # [N, H, W]
    poses: np.ndarray,  # [N, 4, 4] camera-to-world
    intrinsics: np.ndarray,  # [N, 3, 3]
    max_points: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unproject the masked pixels of valid depth of every frame into one
    world point cloud.  Returns (xyz [P, 3], rgb [P, 3] in [0, 1]); with
    `max_points`, a subset drawn without replacement from `seed`."""
    n = images.shape[0]
    for name, t in (("depths", depths), ("masks", masks), ("poses", poses),
                    ("intrinsics", intrinsics)):
        if t.shape[0] != n:
            raise ValueError(f"leading dim mismatch: images {n} vs {name} {t.shape[0]}")
    h, w = images.shape[1:3]
    images_f = (images.astype(np.float32) / 255.0 if images.dtype == np.uint8
                else images.astype(np.float32))
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xyz_all, rgb_all = [], []
    for i in range(n):
        valid = (masks[i] != 0) & (depths[i] > 0)
        if not valid.any():
            continue
        ui, vi = u[valid].astype(np.float32), v[valid].astype(np.float32)
        di = depths[i][valid].astype(np.float32)
        k = intrinsics[i]
        x = (ui - k[0, 2]) * di / k[0, 0]
        y = (vi - k[1, 2]) * di / k[1, 1]
        pts_cam = np.stack([x, y, di], axis=-1)
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        xyz_all.append(pts_cam @ R.T + t)
        rgb_all.append(images_f[i][valid])
    if not xyz_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    xyz = np.concatenate(xyz_all).astype(np.float32)
    rgb = np.concatenate(rgb_all).astype(np.float32)
    if max_points is not None and len(xyz) > max_points:
        idx = np.random.default_rng(seed).choice(len(xyz), max_points, replace=False)
        xyz, rgb = xyz[idx], rgb[idx]
    return xyz, rgb


def knn_scale_init(points: np.ndarray, k: int = 4, init_scale: float = 1.0) -> np.ndarray:
    """Per-point log scales [N, 3] from the mean distance to the k-1
    nearest neighbours, times `init_scale`."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k)
    mean_d = d[:, 1:].mean(axis=1)
    return np.log(np.clip(mean_d * init_scale, 1e-7, None)).astype(np.float32)[:, None].repeat(
        3, axis=1)
