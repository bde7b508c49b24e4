"""COLMAP scene parser and view dataset (numpy, no framework).

Port of examples/datasets/colmap.py: the binary and text readers of
cameras / images / points3D (the COLMAP file formats), `Parser` (per-image
camera-to-world matrices, intrinsics divided by `factor`, the 3D points
and their colours, the normalizing similarity transform, `scene_scale`)
and `Dataset` (the `test_every` train / val split).  The readers are the
pure-Python ones; the JAX parser prefers a native reader where it builds,
which gives the same arrays (tests/test_io_native.py).

Images: a PNG is decoded here, with zlib and numpy (8-bit gray, RGB and
RGBA; not interlaced; the five filter types), so
that the card's machine needs no imaging package (`encode_png` writes one,
and `write_model_binary` a binary model, for scenes made by a program).  Any other format goes
through PIL; without PIL it raises an ImportError naming the file and its
format.  Every image is returned as RGB float32 in [0, 1], as the JAX
dataset's `Image.open(path).convert("RGB")` gives it.  For data planes
(the PNG compression's), `decode_png_channels` returns the stored channels
as `np.asarray(PIL.Image.open(path))` does, gray+alpha included, and
`encode_png` writes gray, gray+alpha, RGB and RGBA.
"""

from __future__ import annotations

import importlib.util
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# COLMAP camera model ids -> (name, n_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(fh, fmt):
    return struct.unpack(fmt, fh.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, dict]:
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cams[cam_id] = dict(model=name, width=int(width), height=int(height), params=params)
    return cams


def read_images_binary(path: str) -> Dict[int, dict]:
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            im_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(fh, "<idddddddi")
            name = b""
            while True:
                ch = fh.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n_pts,) = _read(fh, "<Q")
            fh.read(24 * n_pts)  # xys and point ids, unused here
            images[im_id] = dict(quat=np.array([qw, qx, qy, qz]), tvec=np.array([tx, ty, tz]),
                                 camera_id=cam_id, name=name.decode("utf-8"))
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        for i in range(n):
            _pid, x, y, z, r, g, b, e = _read(fh, "<QdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (track_len,) = _read(fh, "<Q")
            fh.read(8 * track_len)
    return xyz, rgb, err


def _text_lines(path: str) -> List[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("#") and line.strip()]


def read_cameras_text(path: str) -> Dict[int, dict]:
    cams = {}
    for line in _text_lines(path):
        parts = line.split()
        cams[int(parts[0])] = dict(model=parts[1], width=int(parts[2]), height=int(parts[3]),
                                   params=np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, dict]:
    images = {}
    for meta_line in _text_lines(path)[0::2]:
        p = meta_line.split()
        images[int(p[0])] = dict(quat=np.array([float(x) for x in p[1:5]]),
                                 tvec=np.array([float(x) for x in p[5:8]]),
                                 camera_id=int(p[8]), name=p[9])
    return images


def read_points3d_text(path: str):
    rows = [line.split() for line in _text_lines(path)]
    xyz = np.array([[float(v) for v in r[1:4]] for r in rows])
    rgb = np.array([[int(v) for v in r[4:7]] for r in rows], np.uint8)
    err = np.array([float(r[7]) for r in rows])
    return xyz, rgb, err


def _qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _intrinsics_from_camera(cam: dict) -> np.ndarray:
    p = cam["params"]
    if cam["model"] in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE",
                        "RADIAL_FISHEYE", "FOV"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:  # PINHOLE, OPENCV, OPENCV_FISHEYE, FULL_OPENCV, THIN_PRISM_FISHEYE
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def similarity_from_cameras(c2w: np.ndarray) -> np.ndarray:
    """The normalizing transform: the cameras' mean up axis to +z, their
    centroid to the origin, their largest distance from it to 1."""
    t = c2w[:, :3, 3]
    up = -c2w[:, :3, 1].mean(0)  # the negative mean of the cameras' y axes
    up = up / np.linalg.norm(up)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s = np.linalg.norm(v)
    c = float(up @ z)
    if s < 1e-8:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    center = t.mean(0)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ center
    t_new = (R @ (t - center).T).T
    scale = 1.0 / max(np.linalg.norm(t_new, axis=1).max(), 1e-8)
    S = np.diag([scale, scale, scale, 1.0])
    return S @ T


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (bit depth 8 only): gray, RGB, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_COLOUR_TYPES = {c: t for t, c in _PNG_CHANNELS.items()}


def _png_unfilter(f: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: f [H, W, bpp] filtered bytes, ftype [H] the
    rows' filter types (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).  Each
    byte's predictor reads the reconstructed bytes to its left (a), above
    (b) and above-left (c) in the same channel.  Without Average and Paeth
    rows, row by row (Sub a running sum along the row); with them, by
    anti-diagonals of pixels, whose left, upper and upper-left neighbours all
    lie on earlier diagonals."""
    H, W, bpp = f.shape
    f = f.astype(np.int32)
    if not (ftype >= 3).any():
        out = np.empty_like(f)
        prev = np.zeros((W, bpp), np.int32)
        for y in range(H):
            row = f[y]
            if ftype[y] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[y] == 2:
                row = row + prev
            prev = out[y] = row & 255
        return out.astype(np.uint8)
    x = np.zeros((H + 1, W + 1, bpp), np.int32)  # row 0 and column 0: the zero border
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H, d + 1))
        i = d - y
        a, b, c = x[y + 1, i], x[y, i + 1], x[y, i]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[y][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3], [0, a, b, (a + b) >> 1], paeth)
        x[y + 1, i + 1] = (f[y, i] + pred) & 255
    return x[1:, 1:].astype(np.uint8)


def _png_pixels(data: bytes, name: str, ctypes) -> Tuple[np.ndarray, int]:
    """The pixels [H, W, channels] uint8 of an 8-bit, non-interlaced PNG of
    one of the colour types `ctypes`, and its colour type."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in ctypes or interlace != 0:
        kinds = ", ".join(f"{t} ({k})" for t, k in ((0, "gray"), (2, "RGB"), (4, "gray+alpha"),
                                                    (6, "RGBA")) if t in ctypes)
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; decoded here: bit depth 8, colour types {kinds}, "
                         "no interlace")
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W * bpp + 1):
        raise ValueError(f"{name}: PNG data of {raw.size} bytes for {W}x{H}x{bpp}")
    rows = raw.reshape(H, W * bpp + 1)
    if rows[:, 0].max() > 4:
        raise ValueError(f"{name}: PNG filter type {int(rows[:, 0].max())}")
    return _png_unfilter(rows[:, 1:].reshape(H, W, bpp), rows[:, 0]), ctype


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB or RGBA PNG as RGB uint8 [H, W, 3]
    (gray replicated, alpha dropped, as PIL's convert("RGB") does)."""
    px, ctype = _png_pixels(data, name, (0, 2, 6))
    if ctype == 0:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_png_channels(data: bytes, name: str = "<png>") -> np.ndarray:
    """An 8-bit, non-interlaced PNG with the channels it stores, as
    np.asarray(PIL.Image.open(...)) gives them: [H, W] gray, [H, W, 2]
    gray+alpha, [H, W, 3] RGB, [H, W, 4] RGBA."""
    px, ctype = _png_pixels(data, name, (0, 2, 4, 6))
    return px[..., 0] if ctype == 0 else px


def encode_png(rgb: np.ndarray, filter_type: Optional[int] = 0, level: int = 6) -> bytes:
    """An 8-bit image [H, W] or [H, W, C] (C = 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA) as PNG bytes, every row with `filter_type` (0 to 4), or with
    None each row with the filter whose residuals, read as signed bytes,
    have the least absolute sum (libpng's choice); compressed at zlib
    `level`."""
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = _PNG_COLOUR_TYPES[C]
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    preds = [np.zeros_like(x), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))]
    if filter_type is None:
        res = np.stack([((x - q) & 255).astype(np.uint8).reshape(H, W * C) for q in preds])
        cost = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=2)  # [5, H]
        ftype = np.argmin(cost, axis=0).astype(np.uint8)
        body = res[ftype, np.arange(H)]
    else:
        ftype = np.full(H, filter_type, np.uint8)
        body = ((x - preds[filter_type]) & 255).astype(np.uint8).reshape(H, W * C)
    raw = np.concatenate([ftype[:, None], body], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """An image file as RGB float32 [H, W, 3] in [0, 1]: a PNG through
    decode_png, any other format through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        rgb = decode_png(data, path)
    else:
        if importlib.util.find_spec("PIL") is None:
            fmt = os.path.splitext(path)[1].lstrip(".").upper() or "unknown"
            raise ImportError(f"{path}: a {fmt} image needs PIL, which is not installed; "
                              "PNG images are decoded without it")
        from PIL import Image

        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
    return rgb.astype(np.float32) / 255.0


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """A rotation matrix as a unit quaternion (w, x, y, z), w >= 0."""
    m = np.asarray(R, np.float64)
    t = np.trace(m)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


def write_model_binary(sparse_dir: str, cameras: Dict[int, dict], viewmats: np.ndarray,
                       camera_ids, names, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """A COLMAP binary model (cameras.bin, images.bin, points3D.bin) in
    `sparse_dir`: `cameras` as read_cameras_binary returns them, one image
    per world-to-camera matrix of `viewmats` [V, 4, 4] with its camera id
    and file name, and the points xyz [N, 3] with colours rgb [N, 3] uint8
    (reprojection error 0, no tracks, no 2D points)."""
    os.makedirs(sparse_dir, exist_ok=True)
    model_ids = {name: (mid, n) for mid, (name, n) in _CAMERA_MODELS.items()}
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, cam in cameras.items():
            mid, n = model_ids[cam["model"]]
            f.write(struct.pack("<iiQQ", cam_id, mid, cam["width"], cam["height"]))
            f.write(struct.pack(f"<{n}d", *np.asarray(cam["params"], np.float64)))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(viewmats)))
        for i, (vm, cam_id, name) in enumerate(zip(viewmats, camera_ids, names)):
            vm = np.asarray(vm, np.float64)
            f.write(struct.pack("<idddddddi", i + 1, *_rotmat_to_qvec(vm[:3, :3]), *vm[:3, 3],
                                cam_id))
            f.write(name.encode("utf-8") + b"\x00" + struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), dtype=np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                             ("err", "<f8"), ("track", "<u8")]))
    rec["id"] = np.arange(1, len(xyz) + 1)
    rec["xyz"], rec["rgb"] = xyz, rgb
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rec.tobytes())


# ---------------------------------------------------------------------------
# Parser and dataset
# ---------------------------------------------------------------------------


@dataclass
class Parser:
    """A COLMAP scene: `data_dir/sparse/0` (or `data_dir/sparse`) holds the
    binary or text model, `data_dir/images_{factor}` (or `images`) the
    images, ordered by name."""

    data_dir: str
    factor: int = 1
    normalize: bool = True
    test_every: int = 8

    image_names: List[str] = field(init=False)
    camtoworlds: np.ndarray = field(init=False)  # [C, 4, 4]
    Ks: np.ndarray = field(init=False)  # [C, 3, 3], divided by factor
    points: np.ndarray = field(init=False)  # [N, 3]
    points_rgb: np.ndarray = field(init=False)  # [N, 3] uint8
    points_err: np.ndarray = field(init=False)
    scene_scale: float = field(init=False)
    transform: np.ndarray = field(init=False)
    image_paths: List[str] = field(init=False)
    widths: List[int] = field(init=False)
    heights: List[int] = field(init=False)

    def __post_init__(self):
        sparse = os.path.join(self.data_dir, "sparse", "0")
        if not os.path.isdir(sparse):
            sparse = os.path.join(self.data_dir, "sparse")
        if os.path.exists(os.path.join(sparse, "cameras.bin")):
            cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
            images = read_images_binary(os.path.join(sparse, "images.bin"))
            xyz, rgb, err = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        else:
            cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
            images = read_images_text(os.path.join(sparse, "images.txt"))
            xyz, rgb, err = read_points3d_text(os.path.join(sparse, "points3D.txt"))

        order = sorted(images.keys(), key=lambda i: images[i]["name"])
        w2c, Ks, names, widths, heights = [], [], [], [], []
        for i in order:
            im = images[i]
            M = np.eye(4)
            M[:3, :3] = _qvec_to_rotmat(im["quat"])
            M[:3, 3] = im["tvec"]
            w2c.append(M)
            cam = cams[im["camera_id"]]
            K = _intrinsics_from_camera(cam).copy()
            K[:2, :] /= self.factor
            Ks.append(K)
            widths.append(cam["width"] // self.factor)
            heights.append(cam["height"] // self.factor)
            names.append(im["name"])
        w2c = np.stack(w2c).astype(np.float32)
        c2w = np.linalg.inv(w2c)

        if self.normalize:
            T = similarity_from_cameras(c2w)
            c2w = T @ c2w
            xyz = (T[:3, :3] @ xyz.T + T[:3, 3:4]).T
        else:
            T = np.eye(4)

        self.transform = T.astype(np.float32)
        self.camtoworlds = c2w.astype(np.float32)
        self.Ks = np.stack(Ks).astype(np.float32)
        self.points = xyz.astype(np.float32)
        self.points_rgb = rgb
        self.points_err = err
        self.image_names = names
        self.widths = widths
        self.heights = heights

        img_dir = os.path.join(self.data_dir,
                               f"images_{self.factor}" if self.factor > 1 else "images")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(self.data_dir, "images")
        self.image_paths = [os.path.join(img_dir, n) for n in names]

        # the largest camera distance from the cameras' centroid
        centers = self.camtoworlds[:, :3, 3]
        self.scene_scale = float(np.linalg.norm(centers - centers.mean(0), axis=1).max())


class Dataset:
    """The train or val split of a parser's views: every `test_every`-th
    view (from view 0) is val."""

    def __init__(self, parser: Parser, split: str = "train", load_images: bool = True):
        self.parser = parser
        idx = np.arange(len(parser.image_names))
        if parser.test_every > 0:
            if split == "train":
                idx = idx[idx % parser.test_every != 0]
            else:
                idx = idx[idx % parser.test_every == 0]
        self.indices = idx
        self.load_images = load_images

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        j = int(self.indices[i])
        item = dict(K=self.parser.Ks[j], camtoworld=self.parser.camtoworlds[j], image_id=j,
                    width=self.parser.widths[j], height=self.parser.heights[j])
        if self.load_images:
            item["image"] = load_image(self.parser.image_paths[j])
        return item
