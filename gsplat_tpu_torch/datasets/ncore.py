"""NCore v4 driving-sequence reader (numpy, without the NCore SDK).

Port of `examples/datasets/ncore.py` (:60-262, :290-821): multi-camera rigs
with pinhole, fisheye and f-theta models, rolling-shutter START / END
poses, ego masks, lidar point clouds for the gaussians' start, and rigid
dynamic object tracks, all on a narrow `SequenceSource` protocol (below),
for `av_trainer.ncore_scene`.  The SDK adapter that opens an on-disk
sequence (`open_ncore_sequence`, :264-288) needs the proprietary `ncore`
package and is not ported: NCoreParser takes an in-memory source.  The
f-theta record is the port's `sensors.params.FThetaCameraDistortionParameters`;
images and masks that do not match the camera's size are resized as PIL
resizes (datasets/resize.py), since the card's machine has no PIL.

SequenceSource protocol (duck-typed, everything numpy):

- ``sequence_id: str``
- ``time_range_us: (start, stop)`` int
- ``camera_ids: list[str]``, ``point_cloud_ids: list[str]``
- ``world_to_world_global: (4,4) | None`` — pose-graph edge
- ``camera(cid) -> CameraSource`` with:
    - ``params``: PinholeParams | FisheyeParams | FThetaParams
    - ``frames_timestamps_us``: (N, 2) int64 [START, END]
    - ``pose_world(frame_indices, timepoint)``: (N, 4, 4) cam->world,
      timepoint in {"start", "end"} (rolling-shutter endpoints)
    - ``ego_mask() -> (H, W) bool | None`` (True = ego vehicle)
    - ``image(frame_idx) -> (H, W, 3) uint8``
    - ``frame_mask(frame_idx) -> (H, W) bool | None`` (True = valid)
- ``point_cloud_source(pid) -> PointCloudSource`` with:
    - ``pc_timestamps_us``: (M,) int64
    - ``pc_world(idx) -> (xyz_world (P,3) f32, rgb (P,3) u8 | None,
      dynamic_flag (P,) bool | None)``
- ``cuboid_tracks(time_range) -> list[CuboidObservation]``
  (world-frame boxes at lidar reference timestamps)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sensors.params import FThetaCameraDistortionParameters, FThetaPolynomialType
from .normalize import (
    align_principal_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)
from .resize import resize_bilinear_u8, resize_nearest


# ---------------------------------------------------------------------------
# Camera / track parameter records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PinholeParams:
    """OpenCV pinhole: K + optional radial/tangential/thin-prism."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    radial_coeffs: Optional[np.ndarray] = None  # (4|6,)
    tangential_coeffs: Optional[np.ndarray] = None  # (2,)
    thin_prism_coeffs: Optional[np.ndarray] = None  # (4,)

    def scaled(self, factor: float) -> "PinholeParams":
        return dataclasses.replace(
            self,
            width=_scaled_dim(self.width, factor),
            height=_scaled_dim(self.height, factor),
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=self.cx / factor,
            cy=self.cy / factor,
        )


@dataclasses.dataclass
class FisheyeParams:
    """OpenCV fisheye: K + 4 radial theta-poly coefficients."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    radial_coeffs: np.ndarray = None  # (4,)

    scaled = PinholeParams.scaled


@dataclasses.dataclass
class FThetaParams:
    """NVIDIA f-theta: angle<->pixel-distance polynomials.

    Field semantics match `sensors.params.FThetaCameraDistortionParameters`.
    """

    width: int
    height: int
    cx: float
    cy: float
    reference_poly: str  # "pixeldist_to_angle" | "angle_to_pixeldist"
    pixeldist_to_angle_poly: Tuple[float, ...]
    angle_to_pixeldist_poly: Tuple[float, ...]
    max_angle: float
    linear_cde: Tuple[float, float, float] = (1.0, 0.0, 0.0)

    def scaled(self, factor: float) -> "FThetaParams":
        if factor == 1.0:
            return self
        # pixel-distance polynomials rescale with the image domain
        p2a = tuple(
            c * factor**i
            for i, c in enumerate(self.pixeldist_to_angle_poly)
        )
        a2p = tuple(c / factor for c in self.angle_to_pixeldist_poly)
        return dataclasses.replace(
            self,
            width=_scaled_dim(self.width, factor),
            height=_scaled_dim(self.height, factor),
            cx=self.cx / factor,
            cy=self.cy / factor,
            pixeldist_to_angle_poly=p2a,
            angle_to_pixeldist_poly=a2p,
        )


def _scaled_dim(dim: int, factor: float) -> int:
    scaled = dim / factor
    if abs(scaled - round(scaled)) > 1e-6:
        raise ValueError(
            f"factor={factor} produces non-integer resolution for dim {dim}; "
            "pass factor=1 (upstream gsplat's ncore.py:383-389 raises the same way)"
        )
    return int(round(scaled))


@dataclasses.dataclass
class CameraRenderData:
    """Per-camera parameters routed to `rendering.rasterization`.

    Parity: upstream gsplat's ncore.py:55-66 (CameraRenderData).
    """

    camera_model: str  # "pinhole" | "fisheye" | "ftheta"
    ftheta_coeffs: Optional[object] = None  # sensors.FThetaCameraDistortionParameters
    radial_coeffs: Optional[np.ndarray] = None
    tangential_coeffs: Optional[np.ndarray] = None
    thin_prism_coeffs: Optional[np.ndarray] = None


@dataclasses.dataclass
class CuboidObservation:
    """One world-frame cuboid observation of a tracked object.

    ``bbox_world`` layout (9,): center xyz, full sizes lwh, yaw-pitch-roll
    (radians, applied z-y-x). Upstream gsplat reads NCore ``bbox3.to_array()``;
    this is the protocol's explicit equivalent.
    """

    track_id: str
    class_id: str
    timestamp_us: int  # reference_frame_timestamp_us (lidar-aligned)
    bbox_world: np.ndarray  # (9,)


@dataclasses.dataclass
class RigidDynamicTrack:
    """A moving object reconstructed as a rigid component.

    Parity: upstream gsplat's ncore.py:68-82 — Gaussians init from lidar points in
    the object-local (centroid-centred) frame; per-keyframe SE(3) poses map
    local -> scene at each annotated timestamp.
    """

    track_id: str
    class_id: str
    points_local: np.ndarray  # (P, 3) f32
    points_rgb: np.ndarray  # (P, 3) u8
    frame_timestamps_us: np.ndarray  # (F,) i64 sorted
    poses_local_to_scene: np.ndarray  # (F, 4, 4) f32


# ---------------------------------------------------------------------------
# Cuboid geometry helpers (upstream gsplat uses ncore.impl.common.transformations)
# ---------------------------------------------------------------------------


def bbox_pose(bbox: np.ndarray) -> np.ndarray:
    """4x4 local->world pose of a (9,) cuboid (centroid-centred local frame)."""
    cx, cy, cz, _, _, _, yaw, pitch, roll = (float(v) for v in bbox)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = (cx, cy, cz)
    return T


def se3_inverse(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def points_in_bbox(xyz_world: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    """Boolean mask of points inside the (9,) world-frame cuboid."""
    local = transform_points(se3_inverse(bbox_pose(bbox)), xyz_world)
    half = np.asarray(bbox[3:6], np.float64) / 2.0
    return np.all(np.abs(local) <= half + 1e-6, axis=1)


class FrameConversion:
    """Origin-shift + uniform scale + axis permutation between frames.

    Role parity: upstream gsplat's ncore_utils.py:FrameConversion (which packs the
    same data into a 4x4 with 1/scale in [3,3]); stored unpacked here.
    ``transform_points``: x -> scale * P @ (x - origin);
    ``transform_poses``: R -> P @ R, t -> scale * P @ (t - origin).
    """

    def __init__(
        self,
        origin: np.ndarray,
        scale: float = 1.0,
        axis: Sequence[int] = (0, 1, 2),
    ):
        assert len(set(axis)) == 3
        self.origin = np.asarray(origin, np.float64).reshape(3)
        self.target_scale = float(scale)
        self.perm = np.eye(3)[list(axis)]

    def transform_points(self, xyz: np.ndarray) -> np.ndarray:
        return self.target_scale * (xyz - self.origin) @ self.perm.T

    def transform_poses(self, poses: np.ndarray) -> np.ndarray:
        poses = np.asarray(poses, np.float64).reshape(-1, 4, 4)
        out = poses.copy()
        out[:, :3, :3] = self.perm[None] @ poses[:, :3, :3]
        out[:, :3, 3] = self.transform_points(poses[:, :3, 3])
        return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class NCoreParser:
    """Eager metadata parser over a SequenceSource.

    Field semantics per upstream gsplat's parser (ncore.py:129-262):

    - ``camtoworlds`` / ``camtoworlds_end``: (N,4,4) scene-frame poses at
      the rolling-shutter START / END timepoints, one row per
      (camera, frame) in ``frame_list``.
    - ``Ks_dict`` / ``imsize_dict`` / ``mask_dict`` /
      ``camera_render_data``: per camera-id.
    - ``points`` / ``points_rgb``: scene-frame lidar init cloud.
    - ``rigid_dynamic_tracks``: see RigidDynamicTrack.
    - ``scene_scale``: max camera distance from the mean camera position
      (COLMAP convention, upstream gsplat's ncore.py:252-257).
    """

    def __init__(
        self,
        source,
        factor: float = 1.0,
        test_every: int = 8,
        camera_ids: Optional[List[str]] = None,
        seek_offset_sec: Optional[float] = None,
        duration_sec: Optional[float] = None,
        max_lidar_points: int = 500_000,
        lidar_step_frame: int = 1,
        normalize_world_space: bool = False,
        rigid_dynamic_track_class_ids: Optional[Sequence[str]] = None,
        seed: int = 0,
    ):
        if isinstance(source, str):
            raise NotImplementedError(
                f"{source}: opening an NCore sequence from its meta-json needs the NCore SDK "
                "adapter (examples/datasets/ncore.py:open_ncore_sequence), which is not ported; "
                "pass an in-memory SequenceSource")
        self.source = source
        self.factor = float(factor)
        self.test_every = int(test_every)
        self.normalize_world_space = bool(normalize_world_space)
        self.sequence_id = source.sequence_id

        if rigid_dynamic_track_class_ids is not None:
            self.rigid_dynamic_track_class_ids = frozenset(
                str(c).strip().lower() for c in rigid_dynamic_track_class_ids
            )
            if not self.rigid_dynamic_track_class_ids:
                raise ValueError(
                    "rigid_dynamic_track_class_ids must be non-empty when given"
                )
        else:
            self.rigid_dynamic_track_class_ids = None

        # time window
        start_us, stop_us = (int(t) for t in source.time_range_us)
        if seek_offset_sec is not None:
            start_us += int(seek_offset_sec * 1e6)
        if duration_sec is not None and duration_sec > 0:
            stop_us = min(start_us + int(duration_sec * 1e6), stop_us)
        self.time_range_us = (start_us, stop_us)

        # sensor selection (explicit ids required when ambiguous,
        # upstream gsplat's ncore.py:300-345)
        available = list(source.camera_ids)
        if not camera_ids:
            if len(available) > 1:
                raise ValueError(
                    "multiple cameras in sequence; specify camera_ids "
                    f"explicitly: {available}"
                )
            camera_ids = available
        unknown = [c for c in camera_ids if c not in available]
        if unknown:
            raise ValueError(f"camera_ids {unknown} not in sequence {available}")
        self.camera_ids = list(camera_ids)
        self.num_cameras = len(self.camera_ids)

        # world -> world_global
        edge = getattr(source, "world_to_world_global", None)
        self.T_world_to_scene_world = (
            np.asarray(edge, np.float64)
            if edge is not None
            else np.eye(4)
        )

        # camera intrinsics / render data / ego masks
        self._load_camera_data()

        # per-camera frame index ranges within the time window
        self._frame_ranges = {
            cid: self._frames_in_window(
                source.camera(cid).frames_timestamps_us
            )
            for cid in self.camera_ids
        }

        self._compute_scene_origin()
        self._load_poses()

        # render_traj compatibility stubs (upstream gsplat's ncore.py:228-230)
        self.bounds = np.array([0.01, 1.0])

        self.points, self.points_rgb = self._load_point_clouds(
            max_lidar_points, lidar_step_frame, seed
        )

        self.rigid_dynamic_tracks: List[RigidDynamicTrack] = (
            self._load_rigid_dynamic_tracks(lidar_step_frame)
            if self.rigid_dynamic_track_class_ids is not None
            else []
        )

        if self.normalize_world_space:
            self._normalize_world_space()

        cam_pos = self.camtoworlds[:, :3, 3]
        dists = np.linalg.norm(cam_pos - cam_pos.mean(axis=0), axis=1)
        self.scene_scale = float(dists.max()) if len(dists) else 1.0

    # -- init helpers -------------------------------------------------

    def _load_camera_data(self) -> None:
        self.Ks_dict: Dict[str, np.ndarray] = {}
        self.imsize_dict: Dict[str, Tuple[int, int]] = {}
        self.mask_dict: Dict[str, Optional[np.ndarray]] = {}
        self.camera_render_data: Dict[str, CameraRenderData] = {}

        for cid in self.camera_ids:
            cam = self.source.camera(cid)
            params = cam.params
            if self.factor != 1.0:
                params = params.scaled(self.factor)
            self.imsize_dict[cid] = (params.width, params.height)

            kind = _camera_kind(params)
            if kind == "ftheta":
                self.Ks_dict[cid] = np.array(
                    [[1, 0, params.cx], [0, 1, params.cy], [0, 0, 1]],
                    np.float32,
                )
                ref = (
                    FThetaPolynomialType.PIXELDIST_TO_ANGLE
                    if params.reference_poly == "pixeldist_to_angle"
                    else FThetaPolynomialType.ANGLE_TO_PIXELDIST
                )
                self.camera_render_data[cid] = CameraRenderData(
                    camera_model="ftheta",
                    ftheta_coeffs=FThetaCameraDistortionParameters(
                        reference_poly=ref,
                        pixeldist_to_angle_poly=tuple(
                            params.pixeldist_to_angle_poly
                        ),
                        angle_to_pixeldist_poly=tuple(
                            params.angle_to_pixeldist_poly
                        ),
                        max_angle=float(params.max_angle),
                        linear_cde=tuple(params.linear_cde),
                    ),
                )
            elif kind == "fisheye":
                self.Ks_dict[cid] = _K_from(params)
                self.camera_render_data[cid] = CameraRenderData(
                    camera_model="fisheye",
                    radial_coeffs=np.asarray(params.radial_coeffs, np.float32),
                )
            else:
                self.Ks_dict[cid] = _K_from(params)
                self.camera_render_data[cid] = CameraRenderData(
                    camera_model="pinhole",
                    radial_coeffs=_nonzero_or_none(params.radial_coeffs),
                    tangential_coeffs=_nonzero_or_none(
                        params.tangential_coeffs
                    ),
                    thin_prism_coeffs=_nonzero_or_none(
                        params.thin_prism_coeffs
                    ),
                )

            mask = cam.ego_mask()
            if mask is not None:
                mask = _dilate_bool(np.asarray(mask, bool), 30)
            self.mask_dict[cid] = mask

    def _frames_in_window(self, ts: np.ndarray) -> range:
        """Frame indices whose START and END timestamps lie in the window."""
        start, stop = self.time_range_us
        ok = (ts[:, 0] >= start) & (ts[:, 1] < stop)
        idx = np.nonzero(ok)[0]
        if len(idx) == 0:
            return range(0)
        return range(int(idx[0]), int(idx[-1]) + 1)

    def _compute_scene_origin(self) -> None:
        positions = []
        for cid in self.camera_ids:
            rng = self._frame_ranges[cid]
            if not len(rng):
                continue
            T = self.source.camera(cid).pose_world(
                np.arange(rng.start, rng.stop), "start"
            )
            pos = T.reshape(-1, 4, 4)[:, :3, 3]
            positions.append(
                pos @ self.T_world_to_scene_world[:3, :3].T
                + self.T_world_to_scene_world[:3, 3]
            )
        mean_pos = (
            np.vstack(positions).mean(axis=0)
            if positions
            else np.zeros(3)
        )
        self.world_global_to_scene = FrameConversion(origin=mean_pos)

    def _world_to_scene_poses(self, T_world: np.ndarray) -> np.ndarray:
        T = self.T_world_to_scene_world[None] @ T_world.reshape(-1, 4, 4)
        return self.world_global_to_scene.transform_poses(T)

    def _load_poses(self) -> None:
        self.frame_list: List[Tuple[str, int]] = []
        self.camera_idx_per_frame: List[int] = []
        starts, ends = [], []
        for cam_idx, cid in enumerate(self.camera_ids):
            rng = self._frame_ranges[cid]
            if not len(rng):
                continue
            cam = self.source.camera(cid)
            indices = np.arange(rng.start, rng.stop)
            T_start = self._world_to_scene_poses(
                cam.pose_world(indices, "start")
            )
            T_end = self._world_to_scene_poses(cam.pose_world(indices, "end"))
            for k, fidx in enumerate(rng):
                self.frame_list.append((cid, fidx))
                self.camera_idx_per_frame.append(cam_idx)
                starts.append(T_start[k])
                ends.append(T_end[k])
        self.camtoworlds = np.stack(starts).astype(np.float64)
        self.camtoworlds_end = np.stack(ends).astype(np.float64)

    def _load_point_clouds(self, max_points, step_frame, seed):
        start, stop = self.time_range_us
        T_ws = self._world_to_scene_poses(np.eye(4)[None])[0]
        scale = self.world_global_to_scene.target_scale
        keep_dynamic = self.rigid_dynamic_track_class_ids is not None

        all_pts, all_rgb = [], []
        for pid in self.source.point_cloud_ids:
            src = self.source.point_cloud_source(pid)
            ts = src.pc_timestamps_us
            for i in range(len(ts)):
                if not (start <= int(ts[i]) < stop) or i % step_frame:
                    continue
                xyz, rgb, dyn = src.pc_world(i)
                if dyn is not None and not keep_dynamic:
                    xyz = xyz[~dyn]
                    rgb = rgb[~dyn] if rgb is not None else None
                if not len(xyz):
                    continue
                pts = scale * (xyz @ T_ws[:3, :3].T) + T_ws[:3, 3]
                all_pts.append(pts.astype(np.float32))
                all_rgb.append(
                    rgb
                    if rgb is not None
                    else np.full((len(pts), 3), 128, np.uint8)
                )
        if not all_pts:
            return (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.uint8),
            )
        points = np.vstack(all_pts)
        rgb = np.vstack(all_rgb)
        if len(points) > max_points:
            sel = np.random.default_rng(seed).choice(
                len(points), max_points, replace=False
            )
            points, rgb = points[sel], rgb[sel]
        return points, rgb

    def _load_rigid_dynamic_tracks(self, step_frame):
        """Group cuboid observations by track; bind dynamic lidar returns
        to the nearest-in-time cuboid; store points object-locally.

        Parity: upstream gsplat's ncore.py:812-1010 (keyed on the lidar-aligned
        reference timestamps, half-frame-interval match tolerance,
        first-match-wins point assignment).
        """
        start, stop = self.time_range_us
        wanted = self.rigid_dynamic_track_class_ids

        by_track: Dict[str, List[CuboidObservation]] = {}
        for obs in self.source.cuboid_tracks(self.time_range_us):
            by_track.setdefault(obs.track_id, []).append(obs)

        tracks_world = {}
        for track_id, obs_list in by_track.items():
            classes = {str(o.class_id).strip().lower() for o in obs_list}
            if not classes <= wanted:
                continue
            obs_list.sort(key=lambda o: o.timestamp_us)
            ts = np.array([o.timestamp_us for o in obs_list], np.int64)
            bboxes = np.stack([o.bbox_world for o in obs_list]).astype(
                np.float64
            )
            poses_world = np.stack([bbox_pose(b) for b in bboxes])
            tracks_world[track_id] = {
                "class_id": sorted(classes)[0],
                "ts": ts,
                "bbox_world": bboxes,
                "pose_scene": self._world_to_scene_poses(poses_world).astype(
                    np.float32
                ),
            }
        if not tracks_world:
            return []

        all_ts = np.unique(
            np.concatenate([t["ts"] for t in tracks_world.values()])
        )
        ts_tol = (
            max(1_000, int(0.5 * np.median(np.diff(all_ts))))
            if len(all_ts) > 1
            else 100_000
        )

        local_pts = {tid: [] for tid in tracks_world}
        local_rgb = {tid: [] for tid in tracks_world}
        for pid in self.source.point_cloud_ids:
            src = self.source.point_cloud_source(pid)
            ts = src.pc_timestamps_us
            for i in range(len(ts)):
                pc_ts = int(ts[i])
                if not (start <= pc_ts < stop) or i % step_frame:
                    continue
                xyz, rgb, dyn = src.pc_world(i)
                if dyn is None or not np.any(dyn):
                    continue
                xyz = xyz[dyn]
                rgb = rgb[dyn] if rgb is not None else None
                remaining = np.ones(len(xyz), bool)
                for tid, tw in tracks_world.items():
                    nearest = int(np.argmin(np.abs(tw["ts"] - pc_ts)))
                    if abs(int(tw["ts"][nearest]) - pc_ts) > ts_tol:
                        continue
                    bbox = tw["bbox_world"][nearest]
                    sel = points_in_bbox(xyz, bbox) & remaining
                    if not np.any(sel):
                        continue
                    local = transform_points(
                        se3_inverse(bbox_pose(bbox)), xyz[sel]
                    )
                    local_pts[tid].append(local.astype(np.float32))
                    local_rgb[tid].append(
                        rgb[sel]
                        if rgb is not None
                        else np.full((int(sel.sum()), 3), 128, np.uint8)
                    )
                    remaining &= ~sel

        tracks = []
        for tid, tw in tracks_world.items():
            if not local_pts[tid]:
                continue
            tracks.append(
                RigidDynamicTrack(
                    track_id=tid,
                    class_id=tw["class_id"],
                    points_local=np.vstack(local_pts[tid]),
                    points_rgb=np.vstack(local_rgb[tid]),
                    frame_timestamps_us=tw["ts"],
                    poses_local_to_scene=tw["pose_scene"],
                )
            )
        return tracks

    def _normalize_world_space(self) -> None:
        """similarity + PCA + upside-down fix over cameras/points/tracks.

        Parity: upstream gsplat's ncore.py:578-660.
        """
        c2w = self.camtoworlds.astype(np.float64)
        c2w_end = self.camtoworlds_end.astype(np.float64)
        points = self.points.astype(np.float64)

        T1 = similarity_from_cameras(c2w)
        c2w = transform_cameras(T1, c2w)
        c2w_end = transform_cameras(T1, c2w_end)
        if len(points):
            points = transform_points(T1, points)
        T2 = align_principal_axes(points) if len(points) else np.eye(4)
        c2w = transform_cameras(T2, c2w)
        c2w_end = transform_cameras(T2, c2w_end)
        if len(points):
            points = transform_points(T2, points)
        transform = T2 @ T1

        if len(points) and np.median(points[:, 2]) > np.mean(points[:, 2]):
            T3 = np.diag([1.0, -1.0, -1.0, 1.0])
            c2w = transform_cameras(T3, c2w)
            c2w_end = transform_cameras(T3, c2w_end)
            points = transform_points(T3, points)
            transform = T3 @ transform

        self.camtoworlds = c2w
        self.camtoworlds_end = c2w_end
        if len(self.points):
            self.points = points.astype(np.float32)
        self.transform = transform

        if self.rigid_dynamic_tracks:
            # similarity x -> sQx + b: local points scale by s; each pose is
            # left-multiplied then re-orthonormalized (upstream :644-660)
            s = float(np.linalg.norm(transform[0, :3]))
            for track in self.rigid_dynamic_tracks:
                track.points_local = (track.points_local * s).astype(
                    np.float32
                )
                poses = transform @ track.poses_local_to_scene.astype(
                    np.float64
                )
                rs = np.linalg.norm(poses[:, 0, :3], axis=1)
                poses[:, :3, :3] /= rs[:, None, None]
                track.poses_local_to_scene = poses.astype(np.float32)


def _camera_kind(params) -> str:
    """"ftheta", "fisheye" or "pinhole" (FThetaParams, FisheyeParams,
    PinholeParams, or any record with their fields: the SequenceSource
    protocol is duck-typed, so a source may bring its own classes)."""
    if hasattr(params, "pixeldist_to_angle_poly"):
        return "ftheta"
    if hasattr(params, "tangential_coeffs"):
        return "pinhole"
    if hasattr(params, "radial_coeffs"):
        return "fisheye"
    raise TypeError(f"unknown camera params type {type(params)}")


def _K_from(p) -> np.ndarray:
    return np.array(
        [[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1]], np.float32
    )


def _nonzero_or_none(coeffs) -> Optional[np.ndarray]:
    if coeffs is None:
        return None
    arr = np.asarray(coeffs, np.float32)
    return None if (arr == 0).all() else arr


def _dilate_bool(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation (ego-mask safety margin, upstream gsplat's ncore.py:104-111)."""
    from scipy import ndimage

    return ndimage.binary_dilation(mask, iterations=iterations).astype(bool)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class NCoreDataset:
    """Split view over the parser's flat (camera, frame) list.

    Items (numpy, per this repo's dataset convention): ``K`` (3,3),
    ``camtoworld`` / ``camtoworld_end`` (4,4), ``image`` (H,W,3 f32 [0,1]),
    ``image_id``, ``camera_idx``, and optional ``mask`` (H,W bool,
    True = valid pixel — ego mask AND per-frame mask, upstream gsplat's
    ncore.py:1084-1123).
    """

    def __init__(self, parser: NCoreParser, split: str = "train"):
        self.parser = parser
        self.split = split
        idx = np.arange(len(parser.frame_list))
        if split == "train":
            self.indices = idx[idx % parser.test_every != 0]
        else:
            self.indices = idx[idx % parser.test_every == 0]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, item: int) -> dict:
        p = self.parser
        index = int(self.indices[item])
        cid, fidx = p.frame_list[index]
        cam = p.source.camera(cid)
        width, height = p.imsize_dict[cid]

        image = np.asarray(cam.image(fidx))
        if image.shape[:2] != (height, width):
            image = _resize_u8(image, width, height)

        data = {
            "K": p.Ks_dict[cid].copy(),
            "camtoworld": p.camtoworlds[index].astype(np.float32),
            "camtoworld_end": p.camtoworlds_end[index].astype(np.float32),
            "image": image.astype(np.float32) / 255.0,
            # global frame_list index (NOT the split-local position): usable
            # to index camtoworlds/frame_list, and unique across train/test
            # splits so per-frame modules (e.g. ppisp) keyed on it never
            # collide between splits
            "image_id": index,
            "camera_idx": p.camera_idx_per_frame[index],
        }

        valid = None
        ego = p.mask_dict.get(cid)
        if ego is not None:
            valid = ~_fit_mask(ego, width, height)
        fm = cam.frame_mask(fidx)
        if fm is not None:
            fm = _fit_mask(np.asarray(fm, bool), width, height)
            valid = fm if valid is None else (valid & fm)
        if valid is not None:
            data["mask"] = valid
        return data


def _resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    return resize_bilinear_u8(np.asarray(img, np.uint8), width, height)


def _fit_mask(mask: np.ndarray, width: int, height: int) -> np.ndarray:
    if mask.shape == (height, width):
        return mask.astype(bool)
    return resize_nearest(mask.astype(np.uint8) * 255, width, height) != 0
