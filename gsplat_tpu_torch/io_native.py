"""Native readers of COLMAP binary models and 3DGS PLY files.

Port of `gsplat_tpu/io_native.py`: the same functions over the port's own
C++ reader (`csrc/io.cpp`), which `_build.load_host` compiles with g++ into
the gitignored build directory at first use.  Each returns the structures
of the pure-Python readers of `datasets/colmap.py` and of
`exporter.load_ply_to_splats`, which stay as the plain versions the tests
hold these to.  Nothing falls back: a missing g++ or a failed build
raises, so `native_available()` is True or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np

from . import _build

_CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}

_C, _LL, _VP = ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p
# the C signatures of csrc/io.cpp; every entry returns a long long
_SIGNATURES = {
    "colmap_points3d_count": [_C],
    "colmap_points3d_read": [_C, _VP, _VP, _VP],
    "colmap_images_count": [_C],
    "colmap_images_read": [_C, _VP, _VP, _VP, _VP, _VP, _LL],
    "colmap_cameras_count": [_C],
    "colmap_cameras_read": [_C, _VP, _VP, _VP, _VP, _VP, _VP],
    "ply_header": [_C, _VP, _VP, _LL, _VP],
    "ply_read_vertices": [_C, ctypes.c_int64, _LL, ctypes.c_int32, _VP],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("io")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _LL
    return lib


def native_available() -> bool:
    """True once the reader is built and loaded (a failed build raises)."""
    return _lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz [N,3] f64, rgb [N,3] u8, err [N] f64) from points3D.bin."""
    lib = _lib()
    n = lib.colmap_points3d_count(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.colmap_points3d_read(path.encode(), _ptr(xyz), _ptr(rgb), _ptr(err))
    if got != n:
        raise IOError(f"truncated points3D file {path}")
    return xyz, rgb, err


def read_images_binary(path: str) -> Dict[int, dict]:
    """{image_id: {quat wxyz, tvec, camera_id, name}} from images.bin."""
    lib = _lib()
    n = lib.colmap_images_count(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    ids = np.empty(n, np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_cap = 4096 * max(n, 1)
    names = ctypes.create_string_buffer(names_cap)
    got = lib.colmap_images_read(
        path.encode(), _ptr(ids), _ptr(qvecs), _ptr(tvecs), _ptr(cam_ids),
        ctypes.cast(names, ctypes.c_void_p), names_cap,
    )
    if got != n:
        raise IOError(f"truncated images file {path} ({got})")
    name_list = names.raw.split(b"\x00")[:n]
    return {
        int(ids[i]): dict(
            quat=qvecs[i].copy(),
            tvec=tvecs[i].copy(),
            camera_id=int(cam_ids[i]),
            name=name_list[i].decode("utf-8"),
        )
        for i in range(n)
    }


def read_cameras_binary(path: str) -> Dict[int, dict]:
    """{camera_id: {model, width, height, params}} from cameras.bin."""
    lib = _lib()
    n = lib.colmap_cameras_count(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    ids = np.empty(n, np.int32)
    model_ids = np.empty(n, np.int32)
    widths = np.empty(n, np.int64)
    heights = np.empty(n, np.int64)
    params = np.empty((n, 12), np.float64)
    counts = np.empty(n, np.int32)
    got = lib.colmap_cameras_read(
        path.encode(), _ptr(ids), _ptr(model_ids), _ptr(widths),
        _ptr(heights), _ptr(params), _ptr(counts),
    )
    if got != n:
        raise IOError(f"truncated cameras file {path}")
    return {
        int(ids[i]): dict(
            model=_CAMERA_MODEL_NAMES.get(int(model_ids[i]), "UNKNOWN"),
            width=int(widths[i]),
            height=int(heights[i]),
            params=params[i, : counts[i]].copy(),
        )
        for i in range(n)
    }


def read_ply_vertices(path: str) -> Tuple[np.ndarray, list]:
    """(data [N, P] f32, property names) of a binary-LE float PLY."""
    lib = _lib()
    n_props = ctypes.c_int32()
    offset = ctypes.c_int64()
    names_cap = 16384
    names = ctypes.create_string_buffer(names_cap)
    n = lib.ply_header(
        path.encode(), ctypes.byref(n_props),
        ctypes.cast(names, ctypes.c_void_p), names_cap, ctypes.byref(offset),
    )
    if n < 0:
        raise IOError(f"cannot parse PLY header of {path}")
    props = [s.decode() for s in names.raw.split(b"\x00")[: n_props.value]]
    data = np.empty((n, n_props.value), np.float32)
    got = lib.ply_read_vertices(path.encode(), offset.value, n, n_props.value, _ptr(data))
    if got != n:
        raise IOError(f"truncated PLY {path}")
    return data, props


def load_ply_to_splats(path: str) -> Dict[str, np.ndarray]:
    """Native-backed version of exporter.load_ply_to_splats (same output)."""
    data, props = read_ply_vertices(path)
    col = {p: i for i, p in enumerate(props)}
    means = data[:, [col["x"], col["y"], col["z"]]]
    scales = data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    quats = data[:, [col[f"rot_{i}"] for i in range(4)]]
    opacities = data[:, col["opacity"]]
    sh0 = data[:, [col[f"f_dc_{i}"] for i in range(3)]][:, None, :]
    n_rest = len([p for p in props if p.startswith("f_rest_")])
    if n_rest:
        rest = data[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
        # channel-major in the file -> [N, K-1, 3] basis-major
        shN = rest.reshape(len(data), 3, n_rest // 3).transpose(0, 2, 1)
    else:
        shN = np.zeros((len(data), 0, 3), np.float32)
    return dict(
        means=means, scales=scales, quats=quats, opacities=opacities,
        sh0=sh0, shN=np.ascontiguousarray(shN),
    )
