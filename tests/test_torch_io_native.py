"""Port parity: the native COLMAP and PLY readers (gsplat_tpu_torch.io_native,
C++ built by g++) against the JAX package's native readers, the port's own
pure-Python readers (datasets/colmap.py, exporter.load_ply_to_splats) and,
through the parser, a Parser built on those plain readers.

The files are the ones tests/test_io_native.py writes: points3D.bin with
tracks, images.bin with 2D points and names, cameras.bin of two models, a
.ply of the JAX exporter.  Every array equal, bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_io_native import _write_cameras, _write_images, _write_points3d  # noqa: E402

from gsplat_tpu import exporter as jexp  # noqa: E402
from gsplat_tpu import io_native as jnative  # noqa: E402
from gsplat_tpu_torch import _build, io_native  # noqa: E402
from gsplat_tpu_torch import exporter as texp  # noqa: E402
from gsplat_tpu_torch.datasets import colmap as tcolmap  # noqa: E402


def _equal_records(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].keys() == want[k].keys()
        for field, v in want[k].items():
            np.testing.assert_array_equal(got[k][field], v, err_msg=f"{k}.{field}")


def test_the_library_builds_into_the_build_directory():
    assert io_native.native_available()
    path = _build._host_lib_path("io")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert _build.load_host("io") is _build.load_host("io")


def test_points3d(tmp_path):
    p = str(tmp_path / "points3D.bin")
    xyz, rgb, err = _write_points3d(p, n=300)
    got = io_native.read_points3d_binary(p)
    for a, b, c, d in zip(got, jnative.read_points3d_binary(p),
                          tcolmap.read_points3d_binary(p), (xyz, rgb, err)):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)


def test_images(tmp_path):
    p = str(tmp_path / "images.bin")
    ref = _write_images(p, n=11)
    got = io_native.read_images_binary(p)
    _equal_records(got, jnative.read_images_binary(p))
    _equal_records(got, tcolmap.read_images_binary(p))
    _equal_records(got, ref)


def test_cameras(tmp_path):
    p = str(tmp_path / "cameras.bin")
    _write_cameras(p)
    got = io_native.read_cameras_binary(p)
    _equal_records(got, jnative.read_cameras_binary(p))
    _equal_records(got, tcolmap.read_cameras_binary(p))
    assert got[1]["model"] == "PINHOLE" and got[2]["model"] == "OPENCV"


def test_a_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot read"):
        io_native.read_points3d_binary(str(tmp_path / "none.bin"))


def test_ply_against_both_loaders(tmp_path):
    """export_splats (JAX) -> the native load equals the port's plain loader
    and the JAX native one."""
    rng = np.random.default_rng(5)
    n = 40
    arrays = dict(
        means=rng.normal(size=(n, 3)), scales=rng.normal(size=(n, 3)),
        quats=rng.normal(size=(n, 4)), opacities=rng.normal(size=n),
        sh0=rng.normal(size=(n, 1, 3)), shN=rng.normal(size=(n, 8, 3)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    p = str(tmp_path / "splats.ply")
    jexp.export_splats(**arrays, format="ply", save_to=p)
    got = io_native.load_ply_to_splats(p)
    plain = texp.load_ply_to_splats(p)
    jax_native = jnative.load_ply_to_splats(p)
    assert got.keys() == plain.keys() == jax_native.keys()
    for k in plain:
        assert got[k].dtype == plain[k].dtype and got[k].shape == plain[k].shape
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jax_native[k], err_msg=k)
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)


def test_parser_equals_one_on_the_plain_readers(tmp_path, monkeypatch):
    """The Parser reads a binary model through io_native; the same model
    through the plain readers gives the same parser, field for field."""
    from test_torch_colmap import write_scene

    root = str(tmp_path / "scene")
    write_scene(root, binary=True)
    native = tcolmap.Parser(root, factor=2)
    for name in ("read_cameras_binary", "read_images_binary", "read_points3d_binary"):
        monkeypatch.setattr(io_native, name, getattr(tcolmap, name))
    plain = tcolmap.Parser(root, factor=2)
    for k in ("image_names", "image_paths", "widths", "heights"):
        assert getattr(native, k) == getattr(plain, k), k
    for k in ("camtoworlds", "Ks", "points", "points_rgb", "points_err", "transform"):
        np.testing.assert_array_equal(getattr(native, k), getattr(plain, k), err_msg=k)
    assert native.scene_scale == plain.scene_scale
