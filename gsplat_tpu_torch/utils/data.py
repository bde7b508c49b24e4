"""Test and benchmark scenes as numpy arrays.

Port of `gsplat_tpu/utils/data.py`: `load_test_data` crops a scene npz
(upstream gsplat's garden layout: means3d, colors 0..255, viewmats, Ks,
width, height) to an AABB, replicates it over an odd grid of cells to
mimic large scenes, and draws gaussian attributes (scales in [1e-4,
0.02], random unit quats, uniform opacities) from a seeded numpy
generator, the same draws as the JAX function's.  The garden npz is not
bundled: give its path, or set GSPLAT_TPU_TEST_DATA.

`synthetic_test_data` returns the same layout without a file: the scene
that `chip_smoke.py` serves (its `make_splats`, these cameras), 111,785
points uniform in the crop a cell, cells 4 apart, look-at cameras at
3840x2160; the stand-in for the garden scene in the profile presets.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

N_CELL = 111_785  # the garden's points in the [-2, 2]^3 crop
SCENE_CROP = (-2, -2, -2, 2, 2, 2)


def load_test_data(
    data_path: Optional[str] = None,
    scene_crop: Tuple[float, float, float, float, float, float] = SCENE_CROP,
    scene_grid: int = 1,
    seed: int = 42,
):
    """(means, quats, scales, opacities, colors, viewmats, Ks, width, height)
    as numpy arrays, from the npz at `data_path` (or GSPLAT_TPU_TEST_DATA)."""
    assert scene_grid % 2 == 1, "scene_grid must be odd"
    if data_path is None:
        data_path = os.environ.get("GSPLAT_TPU_TEST_DATA")
    if data_path is None:
        raise ValueError("load_test_data: give data_path or set GSPLAT_TPU_TEST_DATA (the "
                         "garden npz is not bundled; synthetic_test_data draws a stand-in)")
    data = np.load(data_path)
    height, width = int(data["height"]), int(data["width"])
    viewmats = data["viewmats"].astype(np.float32)
    Ks = data["Ks"].astype(np.float32)
    means = data["means3d"].astype(np.float32)
    colors = (data["colors"] / 255.0).astype(np.float32)

    aabb = np.array(scene_crop, dtype=np.float32)
    edges = aabb[3:] - aabb[:3]
    sel = ((means >= aabb[:3]) & (means <= aabb[3:])).all(axis=-1)
    means, colors = means[sel], colors[sel]

    repeats = scene_grid
    r = np.arange(-(repeats // 2), repeats // 2 + 1)
    gridx, gridy = np.meshgrid(r, r, indexing="ij")
    grid = np.stack([gridx, gridy, np.zeros_like(gridx)], axis=-1).reshape(-1, 3)
    means = (means[None, :, :] + grid[:, None, :] * edges[None, None, :]).reshape(-1, 3)
    colors = np.tile(colors, (repeats**2, 1))

    N = len(means)
    rng = np.random.default_rng(seed)
    scales = (rng.random((N, 3)) * (0.02 - 1e-4) + 1e-4).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.random((N,)).astype(np.float32)

    return (
        means.astype(np.float32),
        quats,
        scales,
        opacities,
        colors,
        viewmats,
        Ks,
        width,
        height,
    )


def orbit_cameras(means: np.ndarray, n_views: int, width: int, height: int,
                  fov_deg: float = 60.0):
    """(viewmats [n_views, 4, 4], K [3, 3]): an orbit of look-at cameras
    around the points' median at 1.5 times the 70th percentile of their
    distance from it, slightly above, as
    examples/sample_inference.py:orbit_cameras places them."""
    center = np.median(means, axis=0)
    radius = 1.5 * float(np.percentile(np.linalg.norm(means - center, axis=1), 70))
    f = 0.5 * width / math.tan(math.radians(fov_deg) / 2)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = center + np.array([radius * math.cos(a), radius * math.sin(a), -0.3 * radius])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, -1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ eye
        views.append(w2c)
    return np.stack(views), K


def synthetic_test_data(
    scene_grid: int = 1,
    seed: int = 0,
    n_cell: int = N_CELL,
    n_views: int = 4,
    width: int = 3840,
    height: int = 2160,
):
    """load_test_data's layout without a file: `n_cell` points uniform in
    the [-2, 2]^3 crop with random colours, replicated over a scene_grid x
    scene_grid layout of cells 4 apart, with scales, unit quats and
    opacities (clipped to [1e-4, 1 - 1e-4]) drawn in chip_smoke.py's
    make_splats order, and `n_views` orbit cameras."""
    assert scene_grid % 2 == 1, "scene_grid must be odd"
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (n_cell, 3)).astype(np.float32)
    colors = rng.random((n_cell, 3)).astype(np.float32)
    r = np.arange(-(scene_grid // 2), scene_grid // 2 + 1)
    gx, gy = np.meshgrid(r, r, indexing="ij")
    offsets = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3) * 4.0
    means = (base[None] + offsets[:, None].astype(np.float32)).reshape(-1, 3)
    colors = np.tile(colors, (scene_grid * scene_grid, 1))
    N = len(means)
    scales = (rng.random((N, 3)) * (0.02 - 1e-4) + 1e-4).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = np.clip(rng.random((N,)), 1e-4, 1 - 1e-4).astype(np.float32)
    viewmats, K = orbit_cameras(means, n_views, width, height)
    Ks = np.tile(K, (n_views, 1, 1))
    return means, quats, scales, opacities, colors, viewmats, Ks, width, height
