"""Port parity: the COLMAP parser, its dataset and the PNG codec against the
JAX package's examples/datasets/colmap.py (and PIL for the images).

Tiny binary and text models are written here, as tests/test_io_native.py
writes them, with PNG images in RGB, RGBA and gray, every filter type
among them (palette and gray-with-alpha PNGs are refused).  Names, sizes,
indices and splits must be equal; the matrices, points, transform and
scene scale within 1e-6 (both sides do the same float64 numpy arithmetic:
they are in fact equal), the port's rotation blocks those of the JAX
parser with the normalisation's scale divided out; the images equal to
PIL's decode, bit for bit.
"""

import io
import os
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from datasets import colmap as jcolmap  # noqa: E402

from gsplat_tpu_torch.datasets import (  # noqa: E402
    Dataset,
    Parser,
    decode_png,
    encode_png,
    load_image,
    write_model_binary,
)
from gsplat_tpu_torch.datasets import colmap as tcolmap  # noqa: E402

N_VIEWS, W, H = 10, 40, 30
# (PIL mode of the file, filter type of the port's encoder, or None for PIL's own encoder)
IMAGE_KINDS = [("RGB", 0), ("RGBA", 1), ("L", 2), ("RGB", 3), ("RGBA", 4), ("RGB", None),
               ("RGBA", None), ("L", 4), ("L", None), ("RGB", 2)]


def _poses(rng, n):
    """World-to-camera (quat, tvec) of n cameras around the origin."""
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([3 * np.cos(a), 3 * np.sin(a), 1.0 + 0.1 * rng.normal()])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, -1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        out.append((tcolmap._rotmat_to_qvec(R), -R @ eye))
    return out


def _rigid(c2w):
    """The JAX parser's normalised poses with the normalisation's scale
    divided out of their rotation blocks, as the port's parser does
    (examples/datasets/normalize.py:transform_cameras); the translations
    stay."""
    c2w = c2w.copy()
    c2w[:, :3, :3] /= np.linalg.norm(c2w[:, 0, :3], axis=1)[:, None, None]
    return c2w


def _image(rng, mode):
    px = (np.cumsum(rng.integers(0, 40, (H, W, 4)), axis=1) % 256).astype(np.uint8)
    return Image.fromarray(px, "RGBA").convert(mode)


def _write_png(path, im, filter_type):
    if filter_type is None:
        im.save(path, "PNG")
    else:
        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(im), filter_type))


def write_scene(root, binary=True, seed=0):
    """A COLMAP scene of N_VIEWS images in `root` (images and images_2):
    cameras of three models (PINHOLE, SIMPLE_RADIAL, OPENCV) of one size,
    60 points with tracks.  Returns the views' names."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    cams = {1: ("PINHOLE", [50.0, 52.0, 20.0, 15.0]),
            2: ("SIMPLE_RADIAL", [48.0, 19.5, 15.5, 0.01]),
            3: ("OPENCV", [51.0, 49.0, 20.5, 14.5, 0.01, -0.02, 0.001, 0.002])}
    poses = _poses(rng, N_VIEWS)
    # names out of id order: the parser sorts by name
    names = [f"view_{(7 * i) % N_VIEWS:02d}.png" for i in range(N_VIEWS)]
    xyz = rng.uniform(-1, 1, (60, 3))
    rgb = rng.integers(0, 256, (60, 3), dtype=np.uint8)
    err = rng.random(60)
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, (model, params) in cams.items():
                mid = {"PINHOLE": 1, "SIMPLE_RADIAL": 2, "OPENCV": 4}[model]
                f.write(struct.pack("<iiQQ", cid, mid, W, H) + struct.pack(f"<{len(params)}d",
                                                                          *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", N_VIEWS))
            for i, ((q, t), name) in enumerate(zip(poses, names)):
                f.write(struct.pack("<idddddddi", i + 1, *q, *t, i % 3 + 1))
                npts = int(rng.integers(0, 4))
                f.write(name.encode() + b"\x00" + struct.pack("<Q", npts) + b"\x00" * 24 * npts)
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", 60))
            for i in range(60):
                track = int(rng.integers(0, 5))
                f.write(struct.pack("<QdddBBBdQ", i + 1, *xyz[i], *rgb[i], err[i], track)
                        + b"\x00" * 8 * track)
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# Camera list\n")
            for cid, (model, params) in cams.items():
                f.write(f"{cid} {model} {W} {H} {' '.join(repr(p) for p in params)}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# Image list\n")
            for i, ((q, t), name) in enumerate(zip(poses, names)):
                f.write(f"{i + 1} {' '.join(repr(float(v)) for v in (*q, *t))} {i % 3 + 1} "
                        f"{name}\n1.0 2.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# 3D point list\n")
            for i in range(60):
                f.write(f"{i + 1} {' '.join(repr(float(v)) for v in xyz[i])} "
                        f"{' '.join(str(int(v)) for v in rgb[i])} {float(err[i])!r} 1 0\n")
    for sub, size in (("images", (W, H)), ("images_2", (W // 2, H // 2))):
        os.makedirs(os.path.join(root, sub))
        for name, (mode, ft) in zip(names, IMAGE_KINDS):
            im = _image(rng, mode)
            if size != (W, H):
                im = im.resize(size)
            _write_png(os.path.join(root, sub, name), im, ft)
    return names


@pytest.fixture(scope="module", params=["binary", "text"])
def scene_dir(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    write_scene(str(root), binary=request.param == "binary")
    return str(root)


@pytest.mark.parametrize("factor, normalize", [(1, True), (2, True), (1, False)])
def test_parser_and_dataset_match_the_jax_parser(scene_dir, factor, normalize):
    jp = jcolmap.Parser(scene_dir, factor=factor, normalize=normalize, test_every=8)
    tp = Parser(scene_dir, factor=factor, normalize=normalize, test_every=8)
    assert tp.image_names == jp.image_names == sorted(jp.image_names)
    assert tp.image_paths == jp.image_paths
    assert tp.widths == jp.widths == [W // factor] * N_VIEWS
    assert tp.heights == jp.heights == [H // factor] * N_VIEWS
    for k in ("camtoworlds", "Ks", "points", "transform"):
        a, b = getattr(tp, k), getattr(jp, k)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        if k == "camtoworlds":
            b = _rigid(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tp.points_rgb, jp.points_rgb)
    np.testing.assert_allclose(tp.points_err, jp.points_err, rtol=0, atol=1e-12)
    assert tp.scene_scale == pytest.approx(jp.scene_scale, abs=1e-6)
    if not normalize:
        np.testing.assert_array_equal(tp.transform, np.eye(4, dtype=np.float32))
    for split in ("train", "val"):
        jd, td = jcolmap.Dataset(jp, split), Dataset(tp, split)
        np.testing.assert_array_equal(td.indices, jd.indices)
        assert len(td) == len(jd) == (8 if split == "train" else 2)
        for i in range(len(td)):
            a, b = td[i], jd[i]
            assert a.keys() == b.keys()
            assert (a["image_id"], a["width"], a["height"]) == (b["image_id"], b["width"],
                                                                b["height"])
            np.testing.assert_array_equal(a["K"], b["K"])
            assert a["image"].dtype == np.float32 and a["image"].shape == (H // factor,
                                                                           W // factor, 3)
            np.testing.assert_array_equal(a["image"], b["image"])  # PIL's decode, bit for bit
        assert "image" not in Dataset(tp, split, load_images=False)[0]


def test_normalised_poses_are_rigid_and_their_centres_are_the_translations(scene_dir):
    """On a scene whose normalisation scales it (cameras about 3.2 from
    their centroid), each pose's rotation block is orthonormal and the
    camera centres that rasterization() takes from the inverted poses (SH
    view directions) are the parser's c2w translations."""
    from gsplat_tpu_torch.rendering import _campos_from_viewmats

    tp = Parser(scene_dir, normalize=True, test_every=8)
    s = np.linalg.norm(tp.transform[0, :3])
    assert abs(s - 1.0) > 0.5  # the normalisation scales this scene
    R = tp.camtoworlds[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (N_VIEWS, 1, 1)),
                               rtol=0, atol=1e-6)
    viewmats = torch.from_numpy(np.linalg.inv(tp.camtoworlds))
    centres = _campos_from_viewmats(viewmats).numpy()
    np.testing.assert_allclose(centres, tp.camtoworlds[:, :3, 3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode, filter_type",
                         [(m, f) for m in ("L", "RGB", "RGBA") for f in (0, 1, 2, 3, 4, None)])
def test_png_decoder_matches_pil(mode, filter_type):
    """Every colour type the decoder takes, each filter type through the
    port's encoder (gray, RGB and RGBA), and PIL's own encoder (None:
    adaptive filters)."""
    rng = np.random.default_rng(5)
    im = _image(rng, mode)
    buf = io.BytesIO()
    if filter_type is None:
        im.save(buf, "PNG", optimize=True)
        data = buf.getvalue()
    else:
        data = encode_png(np.asarray(im), filter_type)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("mode", ["LA", "P"])
def test_png_decoder_refuses_gray_alpha_and_palette(mode):
    buf = io.BytesIO()
    Image.new(mode, (5, 4)).save(buf, "PNG")
    with pytest.raises(ValueError, match=r"colour type [34].*decoded here"):
        decode_png(buf.getvalue(), f"{mode}.png")


def test_png_decoder_refuses_what_it_does_not_decode(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(buf.getvalue(), "deep.png")
    adam7 = bytearray(encode_png(np.zeros((9, 9, 3), np.uint8)))
    adam7[28] = 1  # IHDR's interlace method: Adam7
    with pytest.raises(ValueError, match="interlace 1"):
        decode_png(bytes(adam7), "adam7.png")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a", "x.gif")


def test_other_formats_go_through_pil_or_name_the_file(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "view.jpg")
    _image(rng, "RGB").save(path, "JPEG")
    want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(load_image(path), want)
    png = str(tmp_path / "view.png")
    _image(rng, "RGB").save(png, "PNG")
    find_spec = tcolmap.importlib.util.find_spec
    monkeypatch.setattr(tcolmap.importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else find_spec(name, *a))
    with pytest.raises(ImportError, match=r"view\.jpg: a JPG image needs PIL"):
        load_image(path)
    # a PNG takes the port's decoder whatever is installed
    want = np.asarray(Image.open(png).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(load_image(png), want)


def test_written_binary_model_reads_back_in_both_parsers(tmp_path):
    """write_model_binary (the chip script's scene writer) against the JAX
    readers: the cameras, each view's world-to-camera matrix (1e-6, through
    the quaternion) and the points."""
    rng = np.random.default_rng(2)
    poses = _poses(rng, 5)
    vms = np.tile(np.eye(4), (5, 1, 1))
    for vm, (q, t) in zip(vms, poses):
        vm[:3, :3], vm[:3, 3] = jcolmap._qvec_to_rotmat(q), t
    cams = {1: dict(model="PINHOLE", width=W, height=H, params=np.array([50.0, 50, 20, 15]))}
    xyz = rng.normal(size=(33, 3))
    rgb = rng.integers(0, 256, (33, 3), dtype=np.uint8)
    sparse = tmp_path / "sparse" / "0"
    names = [f"{i:03d}.png" for i in range(5)]
    write_model_binary(str(sparse), cams, vms, [1] * 5, names, xyz, rgb)
    got_cams = jcolmap.read_cameras_binary(str(sparse / "cameras.bin"))
    assert got_cams[1]["model"] == "PINHOLE" and got_cams[1]["width"] == W
    np.testing.assert_array_equal(got_cams[1]["params"], cams[1]["params"])
    images = jcolmap.read_images_binary(str(sparse / "images.bin"))
    assert [images[i + 1]["name"] for i in range(5)] == names
    for i in range(5):
        R = jcolmap._qvec_to_rotmat(images[i + 1]["quat"])
        np.testing.assert_allclose(R, vms[i][:3, :3], atol=1e-12)
        np.testing.assert_array_equal(images[i + 1]["tvec"], vms[i][:3, 3])
    for read in (jcolmap.read_points3d_binary, tcolmap.read_points3d_binary):
        x, c, e = read(str(sparse / "points3D.bin"))
        np.testing.assert_array_equal(x, xyz)
        np.testing.assert_array_equal(c, rgb)
        assert (e == 0).all()
    os.makedirs(tmp_path / "images")
    for n in names:
        with open(tmp_path / "images" / n, "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)))
    jp, tp = jcolmap.Parser(str(tmp_path), factor=1), Parser(str(tmp_path), factor=1)
    np.testing.assert_allclose(tp.camtoworlds, _rigid(jp.camtoworlds), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(Dataset(tp)[0]["image"], jcolmap.Dataset(jp)[0]["image"])
