"""PNG splat compression (self-organising Gaussian grids).

Port of `gsplat_tpu/compression/png_compression.py:28-381` (after the
reference's gsplat/compression/png_compression.py): crop to a square count
(the lowest opacities go), sort into a 2-D grid (Morton order of the
centres by default, or PLAS), quantise each attribute (16-bit log-space
means in two 8-bit planes; 8-bit scales, quaternions, opacities and sh0), a
k-means codebook for shN, an npz for anything else; `meta.json` beside the
planes, the same keys and values as the JAX package writes, so that each
package decompresses the other's output.

The planes are written and read by the port's own PNG codec
(`datasets/colmap.py:encode_png`, `decode_png_channels`), not PIL, which
the card's machine lacks.  The k-means is Lloyd's algorithm on the device
the caller names (the card by default): the distance block a matrix
product in chunks of 4096 rows, in float32 (PyTorch's default keeps TF32
off for it, as the JAX package asks Precision.HIGHEST), the centre sums by
K5's segment sums over the rows sorted by label (each sum in row order, the
same on every run).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..datasets.colmap import decode_png_channels, encode_png
from ..exporter import sort_centers
from ..ops.segsum_kernel import segment_rowsum
from .plas import plas_sort_indices


def log_transform(x: np.ndarray) -> np.ndarray:
    """sign(x) * log1p(|x|)."""
    return np.sign(x) * np.log1p(np.abs(x))


def inverse_log_transform(y: np.ndarray) -> np.ndarray:
    return np.sign(y) * np.expm1(np.abs(y))


def _write_png(path: str, img: np.ndarray) -> None:
    # each row's filter chosen as libpng chooses it (PIL's encoder does too)
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type=None))


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_channels(f.read(), path)


def _quantize(params: np.ndarray, n_sidelen: int, levels: int):
    """Per-channel min-max quantisation of the grid: (q, mins, maxs)."""
    grid = params.reshape((n_sidelen, n_sidelen, -1))
    mins = grid.min(axis=(0, 1))
    maxs = grid.max(axis=(0, 1))
    norm = (grid - mins) / np.where(maxs - mins == 0, 1, maxs - mins)
    return (norm * levels).round(), mins, maxs


def _compress_png(compress_dir: str, name: str, params: np.ndarray, n_sidelen: int,
                  **kw) -> Dict[str, Any]:
    """8-bit min-max quantisation to one PNG (1, 3 or 4 channels), or to
    groups of at most 4 channels, one PNG each."""
    q, mins, maxs = _quantize(params, n_sidelen, 255)
    img = q.astype(np.uint8)
    meta = {"shape": list(params.shape), "dtype": str(params.dtype), "mins": mins.tolist(),
            "maxs": maxs.tolist()}
    if img.shape[-1] in (1, 3, 4):
        _write_png(os.path.join(compress_dir, f"{name}.png"), img)
        return meta
    for i in range(0, img.shape[-1], 4):
        _write_png(os.path.join(compress_dir, f"{name}_{i // 4}.png"), img[..., i:i + 4])
    meta["split"] = int(np.ceil(img.shape[-1] / 4))
    return meta


def _decompress_png(compress_dir: str, name: str, meta: Dict[str, Any]) -> np.ndarray:
    if "split" in meta:
        parts = [_read_png(os.path.join(compress_dir, f"{name}_{i}.png"))
                 for i in range(meta["split"])]
        img = np.concatenate([p[..., None] if p.ndim == 2 else p for p in parts], axis=-1)
    else:
        img = _read_png(os.path.join(compress_dir, f"{name}.png"))
        if img.ndim == 2:
            img = img[..., None]
    mins = np.array(meta["mins"], np.float32)
    maxs = np.array(meta["maxs"], np.float32)
    vals = img.astype(np.float32) / 255.0 * (maxs - mins) + mins
    return vals.reshape(meta["shape"]).astype(meta["dtype"])


def _compress_png_16bit(compress_dir: str, name: str, params: np.ndarray, n_sidelen: int,
                        **kw) -> Dict[str, Any]:
    """16-bit min-max quantisation in two 8-bit PNGs, the low and the high
    byte."""
    q, mins, maxs = _quantize(params, n_sidelen, 65535)
    q = q.astype(np.uint16)
    _write_png(os.path.join(compress_dir, f"{name}_l.png"), (q & 0xFF).astype(np.uint8))
    _write_png(os.path.join(compress_dir, f"{name}_u.png"), (q >> 8).astype(np.uint8))
    return {"shape": list(params.shape), "dtype": str(params.dtype), "mins": mins.tolist(),
            "maxs": maxs.tolist()}


def _decompress_png_16bit(compress_dir: str, name: str, meta: Dict[str, Any]) -> np.ndarray:
    lo = _read_png(os.path.join(compress_dir, f"{name}_l.png")).astype(np.uint16)
    hi = _read_png(os.path.join(compress_dir, f"{name}_u.png")).astype(np.uint16)
    q = (hi << 8) | lo
    mins = np.array(meta["mins"], np.float32)
    maxs = np.array(meta["maxs"], np.float32)
    vals = q.astype(np.float32) / 65535.0 * (maxs - mins) + mins
    return vals.reshape(meta["shape"]).astype(meta["dtype"])


_KMEANS_CHUNK = 4096  # rows of one distance block: (4096, 65,536) float32 is 1 GiB


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The nearest of `centers` [k, D] to each row of x [n, D]: the argmin
    of |c|^2 - 2 x.c (the first centre on a tie), in chunks of rows."""
    c2 = torch.sum(centers ** 2, dim=-1)
    return torch.cat([torch.argmin(c2[None, :] - 2.0 * (xb @ centers.T), dim=1)
                      for xb in torch.split(x, _KMEANS_CHUNK)])


def _kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
            device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means of the rows of x [n, D] on `device` (the card by
    default): k = min(k, n) initial centres drawn by numpy's
    default_rng(seed) as the JAX package draws them, then `iters` rounds of
    assignment (argmin of |c|^2 - 2 x.c, the first centre on a tie) and
    update (a centre without rows stays).  Returns (centres [k, D] float32,
    labels [n] int64 of the last assignment)."""
    dev = resolve_device(device)
    n, D = x.shape
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centers = torch.from_numpy(x[rng.choice(n, k, replace=False)].astype(np.float32)).to(dev)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    labels = None
    for _ in range(iters):
        labels = _assign(xt, centers)
        # the rows sorted by label, then each centre's rows summed in row order
        order = torch.argsort(labels, stable=True)
        counts = torch.bincount(labels, minlength=k)
        bounds = torch.zeros(k + 1, dtype=torch.int32, device=dev)
        bounds[1:] = torch.cumsum(counts, dim=0)
        sums = segment_rowsum(xt[order].T.contiguous(), bounds).T  # [k, D]
        has = (counts > 0)[:, None]
        centers = torch.where(has, sums / torch.clamp(counts, min=1).to(torch.float32)[:, None],
                              centers)
    return centers.cpu().numpy(), labels.cpu().numpy().astype(np.int64)


def _compress_kmeans(compress_dir: str, name: str, params: np.ndarray, n_sidelen: int,
                     codebook_size: int = 2 ** 16, quantization: int = 8,
                     device: DeviceLike = None, **kw) -> Dict[str, Any]:
    """A k-means codebook (its centres quantised to `quantization` bits, in
    an npz) and each row's 16-bit label in a PNG (high byte, low byte, 0)."""
    shape = params.shape
    x = params.reshape(shape[0], -1).astype(np.float32)
    centers, labels = _kmeans(x, codebook_size, device=device)
    mins, maxs = centers.min(), centers.max()
    norm = (centers - mins) / max(maxs - mins, 1e-12)
    q = (norm * (2 ** quantization - 1)).round().astype(np.uint8)
    np.savez_compressed(os.path.join(compress_dir, f"{name}_codebook.npz"), centroids=q)
    lab = labels.astype(np.uint32).reshape(n_sidelen, n_sidelen)
    img = np.stack([(lab >> 8) & 0xFF, lab & 0xFF, np.zeros_like(lab)], axis=-1).astype(np.uint8)
    _write_png(os.path.join(compress_dir, f"{name}_labels.png"), img)
    return {"shape": list(shape), "dtype": str(params.dtype), "mins": float(mins),
            "maxs": float(maxs), "quantization": quantization}


def _decompress_kmeans(compress_dir: str, name: str, meta: Dict[str, Any]) -> np.ndarray:
    data = np.load(os.path.join(compress_dir, f"{name}_codebook.npz"))
    q = data["centroids"].astype(np.float32)
    centers = q / (2 ** meta["quantization"] - 1) * (meta["maxs"] - meta["mins"]) + meta["mins"]
    img = _read_png(os.path.join(compress_dir, f"{name}_labels.png"))
    labels = (img[..., 0].astype(np.uint32) << 8) | img[..., 1].astype(np.uint32)
    return centers[labels.reshape(-1)].reshape(meta["shape"]).astype(meta["dtype"])


def _compress_npz(compress_dir: str, name: str, params: np.ndarray, **kw) -> Dict[str, Any]:
    np.savez_compressed(os.path.join(compress_dir, f"{name}.npz"), arr=np.asarray(params))
    return {"shape": list(np.asarray(params).shape)}


def _decompress_npz(compress_dir: str, name: str, meta: Dict[str, Any]) -> np.ndarray:
    return np.load(os.path.join(compress_dir, f"{name}.npz"))["arr"]


def _unit_normalize(x: np.ndarray) -> np.ndarray:
    """Per-channel min-max normalisation to [0, 1]."""
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    return (x - mins) / np.where(maxs - mins == 0, 1, maxs - mins)


def sort_splats(splats: Dict[str, np.ndarray], method: str = "morton",
                device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Order the splats (log-space means) for grid locality: "morton", the
    Morton order of the centres; "plas", the PLAS sort of the concatenated
    normalised (means x 8, quats, scales, opacities, sh0) vectors, started
    from the Morton order, on `device`."""
    n = splats["means"].shape[0]
    morton = sort_centers(inverse_log_transform(splats["means"]), np.arange(n))
    if method == "morton":
        idx = morton
    elif method == "plas":
        # the 16-bit means planes dominate the bytes: weight the positions so
        # that the appearance channels do not outvote them
        keys = [("means", 8.0), ("quats", 1.0), ("scales", 1.0), ("opacities", 1.0),
                ("sh0", 1.0)]
        vecs = np.concatenate([w * _unit_normalize(np.asarray(splats[k]).reshape(n, -1))
                               for k, w in keys if k in splats], axis=-1)
        idx = plas_sort_indices(vecs, int(n ** 0.5), normalize=False, init_order=morton,
                                device=device)
    else:
        raise ValueError(f"sort method must be 'morton' or 'plas', got {method!r}")
    return {k: v[idx] for k, v in splats.items()}


def prepare_splats(splats: Dict[str, Any], use_sort: bool = True, sort_method: str = "morton",
                   device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """What `compress` quantises: the splats as numpy arrays with log-space
    means and unit quaternions, cropped to n_sidelen^2 rows (the lowest
    opacities dropped) and, with `use_sort`, sorted."""
    splats = {k: np.asarray(v) for k, v in splats.items()}
    splats["means"] = log_transform(splats["means"])
    splats["quats"] = splats["quats"] / np.linalg.norm(splats["quats"], axis=-1, keepdims=True)
    n_gs = len(splats["means"])
    n_crop = n_gs - int(n_gs ** 0.5) ** 2
    if n_crop != 0:
        keep = np.argsort(splats["opacities"].reshape(n_gs))[n_crop:]
        splats = {k: v[keep] for k, v in splats.items()}
    if use_sort:
        splats = sort_splats(splats, method=sort_method, device=device)
    return splats


_COMPRESS: Dict[str, Callable] = {"means": _compress_png_16bit, "scales": _compress_png,
                                  "quats": _compress_png, "opacities": _compress_png,
                                  "sh0": _compress_png, "shN": _compress_kmeans}
_DECOMPRESS: Dict[str, Callable] = {"means": _decompress_png_16bit, "scales": _decompress_png,
                                    "quats": _decompress_png, "opacities": _decompress_png,
                                    "sh0": _decompress_png, "shN": _decompress_kmeans}


@dataclass
class PngCompression:
    """PNG splat compression: `compress(dir, splats)` and
    `decompress(dir)`.  `sort_method` is "morton" (the default, as in the
    JAX package) or "plas".  The k-means and PLAS run on `device`, the
    card unless the caller names another."""

    use_sort: bool = True
    sort_method: str = "morton"
    verbose: bool = False
    device: DeviceLike = None

    def compress(self, compress_dir: str, splats: Dict[str, Any]) -> Dict[str, float]:
        """Write the planes and `meta.json` of `splats` {means, quats,
        scales (log), opacities (logit), sh0, shN, ...} into compress_dir.
        Returns the seconds of each part: "sort" (log transform, crop and
        sort) and each attribute's writer (shN's is mostly the k-means)."""
        dev = resolve_device(self.device)
        os.makedirs(compress_dir, exist_ok=True)
        t0 = time.perf_counter()
        splats = prepare_splats(splats, self.use_sort, self.sort_method, device=dev)
        seconds = {"sort": time.perf_counter() - t0}
        n_sidelen = int(len(splats["means"]) ** 0.5)
        meta = {}
        for name, value in splats.items():
            t0 = time.perf_counter()
            meta[name] = _COMPRESS.get(name, _compress_npz)(compress_dir, name, value,
                                                            n_sidelen=n_sidelen, device=dev)
            seconds[name] = time.perf_counter() - t0
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        if self.verbose:
            print(f"compressed {n_sidelen ** 2} splats into {compress_dir}: "
                  + json.dumps({k: round(v, 3) for k, v in seconds.items()}), flush=True)
        return seconds

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        """The splats (numpy, means back in linear space) of compress_dir."""
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        splats = {name: _DECOMPRESS.get(name, _decompress_npz)(compress_dir, name, m)
                  for name, m in meta.items()}
        splats["means"] = inverse_log_transform(splats["means"])
        return splats
