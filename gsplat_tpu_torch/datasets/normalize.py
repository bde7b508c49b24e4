"""World-space normalization of a dataset's cameras and points (numpy).

The port's copy of `examples/datasets/normalize.py`, which the NCore
parser (datasets/ncore.py) uses: orient the world so that z+ is up,
recentre at the cameras' focus point, rescale to about unit camera
distances, and align the point cloud's principal axes to the coordinate
axes.  (The COLMAP parser keeps its own normalisation, datasets/colmap.py.)
"""

from __future__ import annotations

import numpy as np


def similarity_from_cameras(
    c2w: np.ndarray,
    strict_scaling: bool = False,
    center_method: str = "focus",
) -> np.ndarray:
    """Similarity transform normalizing OpenCV-convention c2w cameras.

    Steps (upstream gsplat's normalize.py:19-79): rotate the average camera up
    axis (-y in camera space) onto world +z, recenter at the median
    focus point (or camera centroid), rescale by 1/median (or 1/max)
    camera distance. Returns the 4x4 similarity (uniform-scaled SE(3)).
    """
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # world-space up = average of camera-frame -y axes
    world_up = -R[:, :, 1].mean(axis=0)
    world_up = world_up / np.linalg.norm(world_up)

    # rotation taking world_up -> +z (Rodrigues, degenerate-safe)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(world_up, z)
    s = np.linalg.norm(v)
    c = float(world_up @ z)
    if s < 1e-10:
        R_align = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_align = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))

    t_rot = t @ R_align.T
    fwd = (R_align @ R)[:, :, 2]  # camera forward (+z col) after alignment

    if center_method == "focus":
        # closest point to the origin along each camera's center ray
        nearest = t_rot + ((fwd * -t_rot).sum(-1))[:, None] * fwd
        translate = -np.median(nearest, axis=0)
    elif center_method == "poses":
        translate = -np.median(t_rot, axis=0)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    transform = np.eye(4)
    transform[:3, :3] = R_align
    transform[:3, 3] = translate

    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / max(float(scale_fn(np.linalg.norm(t_rot + translate, axis=-1))), 1e-12)
    transform[:3, :] *= scale
    return transform


def align_principal_axes(point_cloud: np.ndarray) -> np.ndarray:
    """SE(3) rotating the cloud's principal axes onto x/y/z (z = smallest).

    Upstream gsplat's normalize.py:82-112: median-centred PCA, eigenvectors
    sorted by descending eigenvalue, right-handedness enforced.
    """
    centroid = np.median(point_cloud, axis=0)
    cov = np.cov(point_cloud - centroid, rowvar=False)
    eigvals, eigvecs = np.linalg.eigh(cov)
    eigvecs = eigvecs[:, eigvals.argsort()[::-1]]
    if np.linalg.det(eigvecs) < 0:
        eigvecs[:, 0] *= -1
    rot = eigvecs.T
    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = -rot @ centroid
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 (possibly scaled) transform to (N, 3) points."""
    assert matrix.shape == (4, 4) and points.ndim == 2 and points.shape[1] == 3
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, camtoworlds: np.ndarray) -> np.ndarray:
    """Left-multiply c2w poses by a similarity, re-orthonormalizing rotations.

    The uniform scale carried by `matrix` moves camera positions but is
    divided back out of the rotation block so poses stay rigid
    (upstream gsplat's normalize.py:129-144).
    """
    assert matrix.shape == (4, 4)
    assert camtoworlds.ndim == 3 and camtoworlds.shape[1:] == (4, 4)
    out = matrix[None] @ camtoworlds
    scaling = np.linalg.norm(out[:, 0, :3], axis=1)
    out = out.copy()
    out[:, :3, :3] = out[:, :3, :3] / scaling[:, None, None]
    return out


def normalize(camtoworlds: np.ndarray, points: np.ndarray | None = None):
    """similarity_from_cameras then (if points given) align_principal_axes.

    Returns (camtoworlds', points', composed_T) with points, else
    (camtoworlds', T1).
    """
    T1 = similarity_from_cameras(camtoworlds)
    camtoworlds = transform_cameras(T1, camtoworlds)
    if points is None:
        return camtoworlds, T1
    points = transform_points(T1, points)
    T2 = align_principal_axes(points)
    return (
        transform_cameras(T2, camtoworlds),
        transform_points(T2, points),
        T2 @ T1,
    )
