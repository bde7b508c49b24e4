"""Spinning lidar sensor model (row-offset structured).

Port of `gsplat_tpu/sensors/lidars.py`.  Image points live in scaled angle
space (azimuth * 1024, elevation * 1024); a ray projects spherically and is
valid inside the field of view.  The structured lidar is a regular
n_rows x n_columns grid of rays, so rasterization runs through the eval3d
op over regular 16x16 element tiles: `angle_extent_to_element_grid` turns a
projected gaussian's angle-space centre and radii into element-grid ones
through the sorted row and column angle tables.

`interp` stands in for `jnp.interp` (linear, clamped to the end values),
on `torch.searchsorted`.  For a 360-degree lidar the relative column
azimuths start at 0 at the field of view's start; a gaussian that
straddles the seam gets a column extent on one side only, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

Tensor = torch.Tensor

ANGLE_TO_PIXEL_SCALING_FACTOR = 1024.0


class SpinningDirection(Enum):
    CLOCKWISE = "clockwise"
    COUNTER_CLOCKWISE = "counter_clockwise"


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, xp ascending; x
    below xp[0] gives fp[0], above xp[-1] gives fp[-1] (numpy.interp)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), side="right"), 1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def normalize_azimuth(a: Tensor) -> Tensor:
    """Wrap to (-pi, pi]."""
    a = torch.where(a > math.pi, a - 2 * math.pi, a)
    return torch.where(a <= -math.pi, a + 2 * math.pi, a)


@dataclasses.dataclass(frozen=True)
class LidarModel:
    """A row-offset structured spinning lidar.  Scalars are Python numbers
    fixed at build; the row and column tables are float32 tensors on one
    device.  `kind` is "lidar", for the camera functions' dispatch."""

    kind: str
    n_rows: int
    n_columns: int
    row_elevations_rad: Tensor  # [n_rows] descending
    column_azimuths_rad: Tensor  # [n_columns] in the spinning direction
    row_azimuth_offsets_rad: Tensor  # [n_rows]
    spinning_direction: SpinningDirection
    spinning_frequency_hz: float
    # field of view: start and span in radians (vertical always clockwise)
    fov_vert_start: float
    fov_vert_span: float
    fov_horiz_start: float
    fov_horiz_span: float
    fov_eps_rad: float

    @property
    def width(self) -> int:
        return self.n_columns

    @property
    def height(self) -> int:
        return self.n_rows

    def to(self, device: DeviceLike) -> "LidarModel":
        """The same lidar with its tables on `device`."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, row_elevations_rad=self.row_elevations_rad.to(dev),
            column_azimuths_rad=self.column_azimuths_rad.to(dev),
            row_azimuth_offsets_rad=self.row_azimuth_offsets_rad.to(dev))

    def rel_azimuth(self, az: Tensor, scale: float = 1.0) -> Tensor:
        """Azimuth relative to the field of view's start, in [0, scale * 2 pi)."""
        if self.spinning_direction == SpinningDirection.CLOCKWISE:
            rel = self.fov_horiz_start * scale - az
        else:
            rel = az - self.fov_horiz_start * scale
        return rel % (scale * 2 * math.pi)

    def rel_elevation(self, el: Tensor, scale: float = 1.0) -> Tensor:
        """Elevation relative to the field of view's start (start - el)."""
        return self.fov_vert_start * scale - el

    def valid_sensor_angles(self, az: Tensor, el: Tensor, scale: float = 1.0) -> Tensor:
        eps = self.fov_eps_rad
        start_v = (self.fov_vert_start + eps) * scale
        cw = self.spinning_direction == SpinningDirection.CLOCKWISE
        start_h = self.fov_horiz_start + eps if cw else self.fov_horiz_start - eps
        rel_el = start_v - el
        if cw:
            rel_az = (start_h * scale - az) % (scale * 2 * math.pi)
        else:
            rel_az = (az - start_h * scale) % (scale * 2 * math.pi)
        return (rel_el <= scale * (self.fov_vert_span + 2 * eps)) & (
            rel_az <= scale * (self.fov_horiz_span + 2 * eps))


def make_lidar(
    row_elevations_rad,
    column_azimuths_rad,
    row_azimuth_offsets_rad,
    spinning_direction: SpinningDirection = SpinningDirection.CLOCKWISE,
    spinning_frequency_hz: float = 10.0,
    fov_eps_factor: int = 4,
    device: DeviceLike = None,
) -> LidarModel:
    """Build a LidarModel on `device` (the card unless named).  The field of
    view comes from the row elevations, the first and last column azimuths
    and the row offsets, in float32 numpy as the JAX package computes it."""
    re = np.asarray(row_elevations_rad, np.float32)
    ca = np.asarray(column_azimuths_rad, np.float32)
    ro = np.asarray(row_azimuth_offsets_rad, np.float32)
    n_rows, n_cols = re.shape[0], ca.shape[0]

    fov_vert_start = float(re[0])
    fov_vert_span = float(re[0] - re[-1])
    if fov_vert_span < 0:
        raise ValueError("row elevations must be descending")

    extremes = ca[None, [0, n_cols - 1]] + ro[:, None]
    if spinning_direction == SpinningDirection.COUNTER_CLOCKWISE:
        start = float(extremes[:, 0].min())
        span = float(extremes[:, -1].max() - start)
    else:
        start = float(extremes[:, 0].max())
        span = float(start - extremes[:, -1].min())
    span = min(span, 2 * math.pi)

    dev = resolve_device(device)
    return LidarModel(
        kind="lidar", n_rows=n_rows, n_columns=n_cols,
        row_elevations_rad=torch.from_numpy(re).to(dev),
        column_azimuths_rad=torch.from_numpy(ca).to(dev),
        row_azimuth_offsets_rad=torch.from_numpy(ro).to(dev),
        spinning_direction=spinning_direction, spinning_frequency_hz=spinning_frequency_hz,
        fov_vert_start=fov_vert_start, fov_vert_span=fov_vert_span,
        fov_horiz_start=start, fov_horiz_span=span,
        fov_eps_rad=fov_eps_factor * float(np.finfo(np.float32).eps),
    )


# ---------------------------------------------------------------------------
# The camera functions' lidar branches (dispatched from sensors.cameras)
# ---------------------------------------------------------------------------


def lidar_ray_to_image_point(lidar: LidarModel, cam_ray: Tensor,
                             margin_factor: float) -> Tuple[Tensor, Tensor]:
    """Sensor-frame rays -> scaled-angle image points [..., 2] and validity;
    the margin is a fraction of the field of view's spans."""
    n = torch.linalg.norm(cam_ray, dim=-1, keepdim=True)
    r = cam_ray / torch.where(n > 0, n, 1.0)
    az = torch.atan2(r[..., 1], r[..., 0])
    el = torch.arcsin(torch.clamp(r[..., 2], -1.0, 1.0))
    pt = torch.stack([az * ANGLE_TO_PIXEL_SCALING_FACTOR, el * ANGLE_TO_PIXEL_SCALING_FACTOR],
                     dim=-1)
    rel_az = lidar.rel_azimuth(az)
    rel_el = lidar.rel_elevation(el)
    m_el = margin_factor * lidar.fov_vert_span
    m_az = margin_factor * lidar.fov_horiz_span
    valid = ((rel_el <= lidar.fov_vert_span + m_el) & (rel_az <= lidar.fov_horiz_span + m_az)
             & (rel_el >= -m_el) & (rel_az >= -m_az))
    return pt, valid


def lidar_image_point_to_ray(lidar: LidarModel, image_point: Tensor) -> Tuple[Tensor, Tensor]:
    """Scaled-angle image points -> unit sensor rays and field-of-view validity."""
    k = 1.0 / ANGLE_TO_PIXEL_SCALING_FACTOR
    az = image_point[..., 0] * k
    el = image_point[..., 1] * k
    ce = torch.cos(el)
    ray = torch.stack([torch.cos(az) * ce, torch.sin(az) * ce, torch.sin(el)], dim=-1)
    return ray, lidar.valid_sensor_angles(az, el)


def _column_table(lidar: LidarModel) -> Tuple[Tensor, Tensor]:
    """(relative column azimuths, column indices), both float32."""
    rel_cols = lidar.rel_azimuth(lidar.column_azimuths_rad)
    return rel_cols, torch.arange(lidar.n_columns, dtype=rel_cols.dtype, device=rel_cols.device)


def lidar_shutter_relative_frame_time(lidar: LidarModel, image_point: Tensor) -> Tensor:
    """Each point's shutter time in [0, 1]: its fractional column over
    n_columns - 1, interpolated on the relative column azimuths (whole
    columns fire at once)."""
    az = image_point[..., 0] * (1.0 / ANGLE_TO_PIXEL_SCALING_FACTOR)
    rel_cols, idx = _column_table(lidar)
    return interp(lidar.rel_azimuth(az), rel_cols, idx) / max(lidar.n_columns - 1, 1)


def lidar_element_image_points(lidar: LidarModel) -> Tensor:
    """[n_rows, n_columns, 2] scaled-angle image points of every element."""
    el = lidar.row_elevations_rad[:, None]
    az = normalize_azimuth(lidar.column_azimuths_rad[None, :]
                           + lidar.row_azimuth_offsets_rad[:, None])
    return torch.stack([az, el.expand_as(az)], dim=-1) * ANGLE_TO_PIXEL_SCALING_FACTOR


def generate_lidar_rays(
    lidar: LidarModel,
    viewmats: Tensor,  # [C, 4, 4] world-to-sensor
    viewmats_rs: Optional[Tensor] = None,
) -> Tensor:
    """World-space rays of every lidar element: [C, n_rows, n_columns, 6].
    With `viewmats_rs`, each column's pose is interpolated at its shutter
    time."""
    from .cameras import interpolate_shutter_pose, pose_camera_ray_to_world_ray, viewmat_to_pose

    pts = lidar_element_image_points(lidar)  # [R, Cc, 2]
    rays_sensor, _ = lidar_image_point_to_ray(lidar, pts)  # [R, Cc, 3]
    C = viewmats.shape[0]
    pose_start = viewmat_to_pose(viewmats)  # [C, 7]
    if viewmats_rs is None:
        pose = pose_start[:, None, None, :]
    else:
        pose_end = viewmat_to_pose(viewmats_rs)
        t = lidar_shutter_relative_frame_time(lidar, pts).expand((C,) + pts.shape[:2])
        pose = interpolate_shutter_pose(pose_start[:, None, None, :], pose_end[:, None, None, :], t)
    rays_sensor = rays_sensor.expand((C,) + tuple(rays_sensor.shape))
    org, dirn = pose_camera_ray_to_world_ray(pose, rays_sensor)
    return torch.cat([org.expand_as(dirn), dirn], dim=-1)


def angle_extent_to_element_grid(
    lidar: LidarModel,
    means2d_angle: Tensor,  # [..., 2] scaled-angle image points
    radii_angle: Tensor,  # [..., 2] int32 scaled-angle radii
) -> Tuple[Tensor, Tensor]:
    """Angle-space centres and radii -> element-grid (column, row) ones.

    Centres map through the relative angle tables; radii scale by the local
    angular spacing at the mapped index, with a 1.5x margin.  The result
    feeds the regular-tile emission plan.
    """
    k = 1.0 / ANGLE_TO_PIXEL_SCALING_FACTOR
    dtype = means2d_angle.dtype
    rel_az = lidar.rel_azimuth(means2d_angle[..., 0] * k)
    rel_el = lidar.rel_elevation(means2d_angle[..., 1] * k)

    rel_cols, idx_c = _column_table(lidar)
    rel_rows = lidar.rel_elevation(lidar.row_elevations_rad)  # ascending
    idx_r = torch.arange(lidar.n_rows, dtype=dtype, device=rel_rows.device)
    col = interp(rel_az, rel_cols, idx_c)
    row = interp(rel_el, rel_rows, idx_r)
    means2d_grid = torch.stack([col, row], dim=-1) + 0.5  # element centres

    # the local spacing (radians per element) at the mapped index
    sp_c = torch.diff(rel_cols)
    sp_r = torch.diff(rel_rows)
    ic = torch.clamp(col.to(torch.int64), 0, lidar.n_columns - 2)
    ir = torch.clamp(row.to(torch.int64), 0, lidar.n_rows - 2)
    loc_c = torch.clamp(sp_c[ic], min=1e-8)
    loc_r = torch.clamp(sp_r[ir], min=1e-8)
    r_az = radii_angle[..., 0].to(dtype) * k
    r_el = radii_angle[..., 1].to(dtype) * k
    radii_grid = torch.stack([torch.ceil(1.5 * r_az / loc_c), torch.ceil(1.5 * r_el / loc_r)],
                             dim=-1)
    radii_grid = torch.where((radii_angle > 0).all(-1)[..., None], radii_grid, 0.0)
    return means2d_grid, radii_grid.to(torch.int32)
