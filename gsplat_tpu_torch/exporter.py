"""Splat exporters: PLY, compressed PLY (Supersplat) and .splat.

Port of gsplat_tpu/exporter.py, host numpy as there (export is no device
work): the same bytes for the same splats (the standard 3DGS PLY property
order, Supersplat's chunked 11-10-11 quantization in Morton order,
antimatter15's .splat records), and the same self-contained reader of a
binary little-endian 3DGS PLY.  Tensors are taken as they are (moved to
the host first).
"""

from __future__ import annotations

import math
import re
from io import BytesIO
from typing import Dict, Tuple

import numpy as np

SH_C0 = 0.28209479177387814


def sh2rgb(sh: np.ndarray) -> np.ndarray:
    """DC SH coefficient -> RGB."""
    return sh * SH_C0 + 0.5


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64) & 0x000003FF
    x = (x ^ (x << 16)) & 0xFF0000FF
    x = (x ^ (x << 8)) & 0x0300F00F
    x = (x ^ (x << 4)) & 0x030C30C3
    x = (x ^ (x << 2)) & 0x09249249
    return x


def encode_morton3(x, y, z) -> np.ndarray:
    """Morton code for 10-bit 3D coordinates."""
    return (_part1by2(z) << 2) + (_part1by2(y) << 1) + _part1by2(x)


def sort_centers(centers: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Order indices by the Morton code of the centers."""
    mn = centers.min(axis=0)
    lengths = centers.max(axis=0) - mn
    lengths[lengths == 0] = 1.0
    scaled = np.floor((centers - mn) / lengths * 1024).astype(np.int32)
    morton = encode_morton3(scaled[:, 0], scaled[:, 1], scaled[:, 2])
    return indices[np.argsort(morton, kind="stable")]


def pack_unorm(value: np.ndarray, bits: int) -> np.ndarray:
    t = (1 << bits) - 1
    return np.clip(np.floor(value * t + 0.5), 0, t).astype(np.int64)


def pack_111011(x, y, z) -> np.ndarray:
    return (pack_unorm(x, 11) << 21) | (pack_unorm(y, 10) << 11) | pack_unorm(z, 11)


def pack_8888(x, y, z, w) -> np.ndarray:
    return (
        (pack_unorm(x, 8) << 24) | (pack_unorm(y, 8) << 16)
        | (pack_unorm(z, 8) << 8) | pack_unorm(w, 8)
    )


def pack_rotation(q: np.ndarray) -> np.ndarray:
    """Largest-component quaternion packing (2+10+10+10 bits)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    largest = np.argmax(np.abs(q), axis=-1)
    rows = np.arange(q.shape[0])
    flip = q[rows, largest] < 0
    q = np.where(flip[:, None], -q, q)
    idx_table = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
    pick = idx_table[largest]  # [N, 3]
    comps = q[rows[:, None], pick]
    scaled = comps * (math.sqrt(2) * 0.5) + 0.5
    packed = pack_unorm(scaled, 10)
    return (
        (largest.astype(np.int64) << 30)
        | (packed[:, 0] << 20) | (packed[:, 1] << 10) | packed[:, 2]
    )


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def splat2ply_bytes(means, scales, quats, opacities, sh0, shN) -> bytes:
    """Standard 3DGS binary PLY.

    sh0 [N, 3] and shN [N, (K-1)*3] are flattened coefficient blocks; shN in
    channel-major (INRIA) order.
    """
    means, scales, quats = _np(means), _np(scales), _np(quats)
    opacities, sh0, shN = _np(opacities), _np(sh0), _np(shN)
    n = means.shape[0]
    buf = BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    buf.write(b"property float x\nproperty float y\nproperty float z\n")
    for i, data in enumerate([sh0, shN]):
        prefix = "f_dc" if i == 0 else "f_rest"
        for j in range(data.shape[1]):
            buf.write(f"property float {prefix}_{j}\n".encode())
    buf.write(b"property float opacity\n")
    for i in range(scales.shape[1]):
        buf.write(f"property float scale_{i}\n".encode())
    for i in range(quats.shape[1]):
        buf.write(f"property float rot_{i}\n".encode())
    buf.write(b"end_header\n")
    data = np.concatenate(
        [means, sh0, shN, opacities[:, None], scales, quats], axis=1
    ).astype("<f4")
    buf.write(data.tobytes())
    return buf.getvalue()


def splat2splat_bytes(means, scales, quats, opacities, sh0) -> bytes:
    """antimatter15 .splat format."""
    means, scales, quats = _np(means), _np(scales), _np(quats)
    opacities, sh0 = _np(opacities), _np(sh0)
    scales = np.exp(scales)
    colors = np.concatenate(
        [sh2rgb(sh0), 1.0 / (1.0 + np.exp(-opacities))[:, None]], axis=1
    )
    colors = np.clip(colors * 255, 0, 255).astype(np.uint8)
    rots = quats / np.linalg.norm(quats, axis=1, keepdims=True) * 128 + 128
    rots = np.clip(rots, 0, 255).astype(np.uint8)
    idx = sort_centers(means, np.arange(means.shape[0]))
    rec = np.zeros(
        means.shape[0],
        dtype=[("m", "<f4", 3), ("s", "<f4", 3), ("c", "u1", 4), ("r", "u1", 4)],
    )
    rec["m"], rec["s"] = means[idx], scales[idx]
    rec["c"], rec["r"] = colors[idx], rots[idx]
    return rec.tobytes()


def splat2ply_bytes_compressed(
    means, scales, quats, opacities, sh0, shN,
    chunk_max_size: int = 256,
    opacity_threshold: float = 1 / 255,
) -> bytes:
    """Supersplat compressed PLY (Morton-ordered chunked quantization)."""
    means, scales, quats = _np(means), _np(scales), _np(quats)
    opacities, sh0, shN = _np(opacities), _np(sh0), _np(shN)
    mask = 1.0 / (1.0 + np.exp(-opacities)) > opacity_threshold
    means, scales, quats = means[mask], scales[mask], quats[mask]
    opacities, shN = opacities[mask], shN[mask]
    sh0_colors = sh2rgb(sh0[mask])
    n = means.shape[0]
    cs = chunk_max_size
    n_chunks = n // cs + (n % cs != 0)
    indices = sort_centers(means, np.arange(n))

    buf = BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element chunk {n_chunks}\n".encode())
    for p in (
        "min_x min_y min_z max_x max_y max_z min_scale_x min_scale_y "
        "min_scale_z max_scale_x max_scale_y max_scale_z min_r min_g min_b "
        "max_r max_g max_b"
    ).split():
        buf.write(f"property float {p}\n".encode())
    buf.write(f"element vertex {n}\n".encode())
    for p in "packed_position packed_rotation packed_scale packed_color".split():
        buf.write(f"property uint {p}\n".encode())
    buf.write(f"element sh {n}\n".encode())
    for j in range(shN.shape[1]):
        buf.write(f"property uchar f_rest_{j}\n".encode())
    buf.write(b"end_header\n")

    chunk_data, splat_data, sh_data = [], [], []
    for ci in range(n_chunks):
        sel = indices[ci * cs : min((ci + 1) * cs, n)]
        cm = means[sel]
        mn_m, mx_m = cm.min(0), cm.max(0)
        csc = np.clip(scales[sel], -20, 20)
        mn_s, mx_s = csc.min(0), csc.max(0)
        cc = sh0_colors[sel]
        mn_c, mx_c = cc.min(0), cc.max(0)
        chunk_data.append(
            np.concatenate([mn_m, mx_m, mn_s, mx_s, mn_c, mx_c])
        )

        nm = (cm - mn_m) / np.where(mx_m - mn_m == 0, 1, mx_m - mn_m)
        ns = (csc - mn_s) / np.where(mx_s - mn_s == 0, 1, mx_s - mn_s)
        nc = (cc - mn_c) / np.where(mx_c - mn_c == 0, 1, mx_c - mn_c)
        opa = 1.0 / (1.0 + np.exp(-opacities[sel]))
        splat_data.append(
            np.stack(
                [
                    pack_111011(nm[:, 0], nm[:, 1], nm[:, 2]),
                    pack_rotation(quats[sel]),
                    pack_111011(ns[:, 0], ns[:, 1], ns[:, 2]),
                    pack_8888(nc[:, 0], nc[:, 1], nc[:, 2], opa),
                ],
                axis=1,
            ).ravel()
        )
        shq = np.clip(np.trunc((shN[sel] / 8 + 0.5) * 256), 0, 255)
        sh_data.append(shq.astype(np.uint8).ravel())

    buf.write(np.concatenate(chunk_data).astype("<f4").tobytes())
    buf.write(np.concatenate(splat_data).astype("<u4").tobytes())
    buf.write(np.concatenate(sh_data).tobytes())
    return buf.getvalue()


def export_splats(
    means, scales, quats, opacities, sh0, shN,
    format: str = "ply",
    save_to: str | None = None,
) -> bytes:
    """Export splats to ply / splat / ply_compressed bytes (optionally saved).

    sh0 [N, 1, 3] and shN [N, K-1, 3] are taken in basis-major layout and
    flattened to the file layouts (shN channel-major, the INRIA convention).
    """
    sh0 = _np(sh0).reshape(len(_np(means)), -1)  # [N, 3]
    shN_a = _np(shN)
    if shN_a.ndim == 3:  # [N, K-1, 3] basis-major -> channel-major flat
        shN_a = shN_a.transpose(0, 2, 1).reshape(shN_a.shape[0], -1)
    if format == "ply":
        data = splat2ply_bytes(means, scales, quats, opacities, sh0, shN_a)
    elif format == "splat":
        data = splat2splat_bytes(means, scales, quats, opacities, sh0)
    elif format == "ply_compressed":
        data = splat2ply_bytes_compressed(
            means, scales, quats, opacities, sh0, shN_a
        )
    else:
        raise ValueError(f"Unsupported format: {format}")
    if save_to:
        with open(save_to, "wb") as f:
            f.write(data)
    return data


def load_ply_to_splats(path: str) -> Dict[str, np.ndarray]:
    """Read a standard 3DGS PLY into splat arrays (the inverse of
    splat2ply_bytes), with no PLY package.  Returns means [N,3], scales
    [N,3] (log), quats [N,4], opacities [N] (logit), sh0 [N,1,3], shN
    [N,K-1,3] (basis-major)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        if "format binary_little_endian 1.0" not in lines[1]:
            raise ValueError(f"{path}: not a binary little-endian PLY ({lines[1]!r})")
        n = None
        props = []
        for line in lines:
            m = re.match(r"element vertex (\d+)", line)
            if m:
                n = int(m.group(1))
            m = re.match(r"property float (\S+)", line)
            if m and n is not None:
                props.append(m.group(1))
        data = np.frombuffer(
            f.read(n * len(props) * 4), dtype="<f4"
        ).reshape(n, len(props))

    col = {p: i for i, p in enumerate(props)}
    means = data[:, [col["x"], col["y"], col["z"]]]
    scales = data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    quats = data[:, [col[f"rot_{i}"] for i in range(4)]]
    opac = data[:, col["opacity"]]
    sh0 = data[:, [col[f"f_dc_{i}"] for i in range(3)]].reshape(n, 1, 3)
    rest = sorted(
        (p for p in props if p.startswith("f_rest_")),
        key=lambda p: int(p.split("_")[-1]),
    )
    if rest:
        fr = data[:, [col[p] for p in rest]]
        k1 = len(rest) // 3
        shN = fr.reshape(n, 3, k1).transpose(0, 2, 1)  # channel-major -> basis-major
    else:
        shN = np.zeros((n, 0, 3), np.float32)
    return dict(
        means=means.copy(), scales=scales.copy(), quats=quats.copy(),
        opacities=opac.copy(), sh0=sh0.copy(), shN=shN.astype(np.float32),
    )
