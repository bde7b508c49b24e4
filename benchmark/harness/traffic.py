"""The one generator of every traffic mix: it reads a mix's parameters
(`traffic/<name>.json`) and gives the cameras, the order in which the
units of work use them, and the training targets.

Kinds of mix:
  * "train": closed-loop training at one view a step.  `views` look-at
    cameras on an orbit around the scene (upstream's `orbit_cameras`: the
    points' median, 1.5 times the 70th percentile of their distance from
    it, 0.3 of that below), each with a target image: a smooth image
    upsampled from a `target_grid` of random colours, stored as uint8 as a
    loader's decoded photographs are.  The seed draws the targets and the
    order (a permutation of the views, then another, ...).
  * "serve": closed-loop render requests from one client, one view each.
    The poses are a fixed set: `azimuths` angles around the orbit,
    the radius factors and elevation factors of the mix taken in turn, so
    every seed sends the same work; the seed draws the order.

Every camera has the mix's field of view, width and height.  A mix with a
key that no code reads is refused (`check_keys`), so that a knob such as a
batch or a client count cannot be written and silently not run.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


KEYS = {
    "train": {"kind", "width", "height", "fov_deg", "views", "target_grid",
              "capacity_headroom", "trace_units"},
    "serve": {"kind", "width", "height", "fov_deg", "azimuths", "radius_scale",
              "elevation_scale", "trace_units"},
}


def check_keys(mix: dict) -> None:
    """Raise unless the mix has exactly the keys of its kind."""
    want = KEYS[mix["kind"]]
    if set(mix) != want:
        raise ValueError(f"a {mix['kind']!r} mix has the keys {sorted(want)}; this one lacks "
                         f"{sorted(want - set(mix))} and has unread {sorted(set(mix) - want)}")


class Cameras(NamedTuple):
    viewmats: torch.Tensor  # [V, 4, 4] world to camera
    K: torch.Tensor  # [3, 3]


def intrinsics(mix: dict) -> np.ndarray:
    W, H = mix["width"], mix["height"]
    f = 0.5 * W / math.tan(math.radians(mix["fov_deg"]) / 2)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def look_at(center: np.ndarray, radius: float, azimuth: float, elevation: float) -> np.ndarray:
    eye = center + np.array([radius * math.cos(azimuth), radius * math.sin(azimuth),
                             elevation * radius])
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def orbit_frame(means: torch.Tensor):
    """(centre, radius) of the orbit: the median point, and 1.5 times the
    70th percentile of the distance from it."""
    center = means.median(dim=0).values
    d = torch.linalg.vector_norm(means - center, dim=-1)
    k = max(1, int(round(0.7 * (d.numel() - 1))) + 1)
    p70 = d.kthvalue(k).values
    return center.double().cpu().numpy(), 1.5 * float(p70)


def cameras(mix: dict, means: torch.Tensor) -> Cameras:
    check_keys(mix)
    center, radius = orbit_frame(means)
    if mix["kind"] == "train":
        n = mix["views"]
        mats = [look_at(center, radius, 2 * math.pi * i / n, -0.3) for i in range(n)]
    else:
        radii, elevs, n = mix["radius_scale"], mix["elevation_scale"], mix["azimuths"]
        mats = [look_at(center, radius * radii[i % len(radii)] / 1.5, 2 * math.pi * i / n,
                        elevs[(i // len(radii)) % len(elevs)]) for i in range(n)]
    dev = means.device
    return Cameras(torch.from_numpy(np.stack(mats)).to(dev),
                   torch.from_numpy(intrinsics(mix)).to(dev))


def order(n_views: int, n_units: int, seed: int) -> List[int]:
    """The view of each unit: seeded permutations of the views, one after
    another."""
    rng = np.random.default_rng(seed)
    out: List[int] = []
    while len(out) < n_units:
        out.extend(int(v) for v in rng.permutation(n_views))
    return out[:n_units]


def targets(mix: dict, n_views: int, g: torch.Generator, device) -> torch.Tensor:
    """Smooth uint8 targets [V, H, W, 3]: each a bilinear upsampling of a
    `target_grid` (rows, columns) of random colours."""
    gh, gw = mix["target_grid"]
    H, W = mix["height"], mix["width"]
    out = torch.empty(n_views, H, W, 3, dtype=torch.uint8, device=device)
    coarse = torch.rand(n_views, 3, gh, gw, generator=g, device=device)
    for v in range(n_views):
        img = F.interpolate(coarse[v:v + 1], size=(H, W), mode="bilinear", align_corners=False)
        out[v] = torch.round(img[0].permute(1, 2, 0) * 255.0).to(torch.uint8)
    return out


def decode(target_u8: torch.Tensor) -> torch.Tensor:
    """A loader's float image in [0, 1] from its uint8 pixels."""
    return target_u8.to(torch.float32) / 255.0
