"""Render-trajectory generators: camera fly-through paths over a capture.

The port's own copy of `examples/datasets/traj.py:20-178` (itself after the
reference's examples/datasets/traj.py): the forward-facing spiral, the
orbit ellipses (z-up and y-up) and the keyframe B-spline path, with
`focus_point`, `average_pose` and `lookat_matrix`.  Numpy and scipy on the
host; the trainer renders the frames on the card.

Every function takes and returns OpenCV-convention camera-to-world
matrices, (N, 3, 4) with +z the look direction.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def lookat_matrix(
    lookdir: np.ndarray, up: np.ndarray, position: np.ndarray
) -> np.ndarray:
    """(3, 4) camera-to-world with +z along `lookdir`."""
    z = _unit(lookdir)
    x = _unit(np.cross(up, z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def focus_point(poses: np.ndarray) -> np.ndarray:
    """Point minimizing squared distance to every camera's optical axis."""
    d = poses[:, :3, 2:3]  # (N, 3, 1) axis directions
    o = poses[:, :3, 3:4]  # (N, 3, 1) origins
    proj = np.eye(3) - d @ np.transpose(d, (0, 2, 1))  # (N, 3, 3)
    a = np.transpose(proj, (0, 2, 1)) @ proj
    # lstsq (not solve): with few cameras or near-parallel axes the normal
    # matrix is singular along the shared axis; min-norm solution picks the
    # point nearest the origin on the degenerate line.
    return np.linalg.lstsq(a.mean(0), (a @ o).mean(0)[:, 0], rcond=None)[0]


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean-position/axis lookat pose of the capture."""
    return lookat_matrix(
        poses[:, :3, 2].mean(0), poses[:, :3, 1].mean(0), poses[:, :3, 3].mean(0)
    )


def generate_spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    spiral_scale_f: float = 1.0,
    spiral_scale_r: float = 1.0,
    focus_distance: float = 0.75,
) -> np.ndarray:
    """Forward-facing spiral around the average pose (LLFF-style)."""
    near, far = float(bounds.min()), float(bounds.max())
    # focus depth: disparity-space blend of the scene bounds
    focal = spiral_scale_f / ((1 - focus_distance) / near + focus_distance / far)

    radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0) * spiral_scale_r
    base = average_pose(poses)
    up = poses[:, :3, 1].mean(0)
    lookat = base @ np.array([0, 0, -focal, 1.0])

    thetas = np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False)
    out = []
    for th in thetas:
        offs = np.array(
            [radii[0] * np.cos(th), -radii[1] * np.sin(th),
             -radii[2] * np.sin(th * zrate), 1.0]
        )
        pos = base @ offs
        out.append(lookat_matrix(pos - lookat, up, pos))
    return np.stack(out)


def _dominant_up(poses: np.ndarray) -> np.ndarray:
    """Coordinate axis closest to the mean camera up vector."""
    avg_up = _unit(poses[:, :3, 1].mean(0))
    k = int(np.argmax(np.abs(avg_up)))
    return np.eye(3)[k] * np.sign(avg_up[k])


def generate_ellipse_path_z(
    poses: np.ndarray,
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height: float = 0.0,
) -> np.ndarray:
    """Orbit ellipse in the xy plane at `height`, looking at the focus."""
    center = focus_point(poses)
    offset = np.array([center[0], center[1], height])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = offset - sc, offset + sc
    z10 = np.percentile(poses[:, :3, 3], 10, axis=0)[2]
    z90 = np.percentile(poses[:, :3, 3], 90, axis=0)[2]

    th = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)[:-1]
    x = low[0] + (high[0] - low[0]) * (np.cos(th) * 0.5 + 0.5)
    y = low[1] + (high[1] - low[1]) * (np.sin(th) * 0.5 + 0.5)
    z = (
        variation
        * (z10 + (z90 - z10) * (np.cos(th + 2 * np.pi * phase) * 0.5 + 0.5))
        + height
    )
    up = _dominant_up(poses)
    return np.stack(
        [lookat_matrix(center - p, up, p) for p in np.stack([x, y, z], -1)]
    )


def generate_ellipse_path_y(
    poses: np.ndarray,
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height: float = 0.0,
) -> np.ndarray:
    """Orbit ellipse in the xz plane (y-up captures)."""
    center = focus_point(poses)
    offset = np.array([center[0], height, center[2]])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = offset - sc, offset + sc
    y10 = np.percentile(poses[:, :3, 3], 10, axis=0)[1]
    y90 = np.percentile(poses[:, :3, 3], 90, axis=0)[1]

    th = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)[:-1]
    x = low[0] + (high[0] - low[0]) * (np.cos(th) * 0.5 + 0.5)
    z = low[2] + (high[2] - low[2]) * (np.sin(th) * 0.5 + 0.5)
    y = (
        variation
        * (y10 + (y90 - y10) * (np.cos(th + 2 * np.pi * phase) * 0.5 + 0.5))
        + height
    )
    up = _dominant_up(poses)
    return np.stack(
        [lookat_matrix(center - p, up, p) for p in np.stack([x, y, z], -1)]
    )


def generate_interpolated_path(
    poses: np.ndarray,
    n_interp: int,
    spline_degree: int = 5,
    smoothness: float = 0.03,
    rot_weight: float = 0.1,
) -> np.ndarray:
    """Smoothing B-spline through the keyframes.

    Each pose becomes a (position, lookat-point, up-point) triple so
    rotation interpolates through point-space (weight `rot_weight`);
    scipy.splprep fits one smoothing spline over the flattened triples.
    Returns (n_interp * (n_poses - 1), 3, 4).
    """
    pos = poses[:, :3, 3]
    look = pos - rot_weight * poses[:, :3, 2]
    upp = pos + rot_weight * poses[:, :3, 1]
    points = np.stack([pos, look, upp], axis=1)  # (N, 3, 3)

    n_out = n_interp * (points.shape[0] - 1)
    flat = points.reshape(points.shape[0], -1)
    k = min(spline_degree, flat.shape[0] - 1)
    tck, _ = scipy.interpolate.splprep(flat.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n_out, endpoint=False)
    new = np.array(scipy.interpolate.splev(u, tck)).T.reshape(n_out, 3, 3)

    return np.stack(
        [lookat_matrix(p - l, u_ - p, p) for p, l, u_ in new]
    )
