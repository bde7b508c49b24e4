"""EndoNeRF surgical dataset reader (numpy, no PIL).

Port of `examples/datasets/endonerf.py`: the EndoNeRF/LLFF directory
layout with per-frame metric depth and binary tool masks, for the dynamic
trainer (`gsplat_tpu_torch.dynamic_trainer`).

Layout::

    <data_dir>/
      poses_bounds.npy            # (N, 17): 15 = [R|t|(H,W,focal)], 2 = near/far
      images/  000000.png ...     # 8-bit gray, RGB or RGBA
      depth/   000000.png ...     # metric depth (8- or 16-bit gray), 0 = no measurement
      masks/   000000.png ...     # binary {0,255}; 255 on disk = TOOL

As in the JAX reader: LLFF pose columns [down, right, back] become [right,
up, back]; masks are inverted on load (1 - mask / 255, so 1 = tissue kept in
the loss); time = index / n_frames; frame i is a test frame iff
(i - 1) % test_every == 0.  PNGs are decoded by `datasets/colmap.py`'s
decoder (16-bit gray for the depth maps), where the JAX reader goes
through PIL, which the card's machine lacks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from .colmap import decode_png, decode_png_channels


def _read_png(path: str, channels: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    return decode_png_channels(data, path) if channels else decode_png(data, path)


class EndoNeRFParser:
    """An EndoNeRF directory as arrays: ``height``, ``width``, ``focal``,
    ``K`` (3,3), ``bounds`` (N,2), ``camtoworlds`` (N,4,4), ``times`` (N,),
    ``image_paths`` / ``depth_paths`` / ``mask_paths``, ``train_idxs`` /
    ``test_idxs`` / ``video_idxs``."""

    def __init__(self, data_dir: str, dataset_type: str = "endonerf", test_every: int = 8):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"data_dir not found: {data_dir}")
        if dataset_type == "scared":
            raise NotImplementedError(
                "dataset_type='scared' is recognised but its on-disk layout (per-frame JSON "
                "calibrations) is not ported; use 'endonerf'.")
        if dataset_type != "endonerf":
            raise ValueError(f"unknown dataset_type {dataset_type!r}")
        self.data_dir = data_dir
        self.test_every = int(test_every)

        pb_path = os.path.join(data_dir, "poses_bounds.npy")
        if not os.path.exists(pb_path):
            raise FileNotFoundError(f"missing poses_bounds.npy at {pb_path}")
        poses_arr = np.load(pb_path)
        n = poses_arr.shape[0]
        poses = poses_arr[:, :15].reshape(n, 3, 5)
        self.bounds = poses_arr[:, 15:].astype(np.float32)

        h, w, focal = poses[0, :, -1]
        self.height, self.width = int(h), int(w)
        self.focal = float(focal)
        self.K = np.array([[self.focal, 0.0, self.width // 2],
                           [0.0, self.focal, self.height // 2],
                           [0.0, 0.0, 1.0]], dtype=np.float32)

        # LLFF [down, right, back] -> [right, up, back]
        c2w = poses[..., :4]
        c2w = c2w[:, :, [1, 0, 2, 3]] * np.array([1.0, -1.0, 1.0, 1.0], dtype=np.float32)
        bottom = np.broadcast_to(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (n, 1, 4))
        self.camtoworlds = np.concatenate([c2w, bottom], axis=1).astype(np.float32)
        self.times = np.arange(n, dtype=np.float32) / n

        def _pngs(sub: str) -> List[str]:
            d = os.path.join(data_dir, sub)
            return sorted(os.path.join(d, f) for f in (os.listdir(d) if os.path.isdir(d) else [])
                          if f.lower().endswith(".png"))

        self.image_paths = _pngs("images")
        self.depth_paths = _pngs("depth")
        self.mask_paths = _pngs("masks")
        for name, paths in (("images", self.image_paths), ("depth", self.depth_paths),
                            ("masks", self.mask_paths)):
            if len(paths) != n:
                raise ValueError(f"{name}/ has {len(paths)} files but poses_bounds.npy has "
                                 f"{n} frames")
        _validate_mask_binary(self.mask_paths[0])

        self.train_idxs = [i for i in range(n) if (i - 1) % test_every != 0]
        self.test_idxs = [i for i in range(n) if (i - 1) % test_every == 0]
        self.video_idxs = list(range(n))


class EndoNeRFDataset:
    """A split of the parser's frames; items are numpy dicts: ``image``
    (H,W,3 f32 in [0,1]), ``depth`` (H,W f32, 0 = no measurement), ``mask``
    (H,W f32, 1 = tissue), ``camtoworld`` (4,4), ``K`` (3,3), ``time`` (f32),
    ``image_id``."""

    def __init__(self, parser: EndoNeRFParser, split: str = "train"):
        self.parser = parser
        self.split = split
        splits: Dict[str, Sequence[int]] = {"train": parser.train_idxs,
                                            "test": parser.test_idxs,
                                            "video": parser.video_idxs}
        if split not in splits:
            raise ValueError(f"unknown split {split!r}; expected train/test/video")
        self.indices = list(splits[split])

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        idx = self.indices[i]
        p = self.parser
        image = _read_png(p.image_paths[idx], channels=False).astype(np.float32) / 255.0
        depth = _read_png(p.depth_paths[idx], channels=True).astype(np.float32)
        mask_raw = _read_png(p.mask_paths[idx], channels=True)
        if mask_raw.ndim == 3:
            mask_raw = mask_raw[..., 0]
        mask = 1.0 - mask_raw.astype(np.float32) / 255.0  # 1 = tissue, 0 = tool
        return {"image": image, "depth": depth, "mask": mask, "camtoworld": p.camtoworlds[idx],
                "K": p.K, "time": np.float32(p.times[idx]), "image_id": idx}


def _validate_mask_binary(mask_path: str) -> None:
    """Raise unless the mask PNG is binary {0, 255} (the tool-mask contract)."""
    arr = _read_png(mask_path, channels=True)
    if arr.ndim == 3:
        arr = arr[..., 0]
    vals = set(np.unique(arr).tolist())
    if not vals.issubset({0, 255}):
        raise ValueError(f"mask {mask_path} is non-binary (values {sorted(vals)[:8]}); masks "
                         "must be {0,255} PNGs (255 = tool)")
