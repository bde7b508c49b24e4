"""Port parity: PNG compression (compression/png_compression.py, plas.py)
and the port's PNG codec against the JAX package and PIL.

* The codec: PIL reads the port's gray, gray+alpha, RGB and RGBA PNGs (each
  filter type, and the per-row choice) to the arrays written, and
  `decode_png_channels` reads PIL's to the arrays PIL gives.
* `_kmeans` on 2,048 seeded rows with k = 64: labels and centres equal to
  the JAX package's (a size where no argmin of near-equal distances
  differs between the two float32 matrix products).
* `plas_sort_indices` on a 16x16 grid of 14-wide vectors: the permutation
  equal to the JAX package's (were a float32 rounding to flip a swap, the
  test warns and holds the grids' neighbour energy within 1e-6 instead).
* PngCompression on 400 gaussians with SH degree 3, either sort: the same
  meta.json, and each package's decompression of either package's output
  equal, array for array.
"""

import io
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gsplat_tpu.compression import plas as jplas
from gsplat_tpu.compression import png_compression as jpng

from gsplat_tpu_torch import PngCompression
from gsplat_tpu_torch.compression import plas as tplas
from gsplat_tpu_torch.compression import png_compression as tpng
from gsplat_tpu_torch.datasets import decode_png_channels, encode_png

MODES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}


def _pixels(rng, mode, H=13, W=17):
    """A smooth ramp with noise (every filter type has work to do)."""
    shape = (H, W) + MODES[mode]
    ramp = np.add.outer(np.arange(H) * 7, np.arange(W) * 3)
    ramp = ramp.reshape((H, W) + (1,) * len(MODES[mode]))
    return ((ramp + rng.integers(0, 40, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode,filter_type",
                         [(m, f) for m in MODES for f in (0, 1, 2, 3, 4, None)])
def test_port_png_reads_in_pil_as_written(mode, filter_type):
    px = _pixels(np.random.default_rng(0), mode)
    with Image.open(io.BytesIO(encode_png(px, filter_type=filter_type))) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), px)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pil_png_reads_in_the_port_as_in_pil(mode):
    px = _pixels(np.random.default_rng(1), mode)
    buf = io.BytesIO()
    Image.fromarray(px, mode).save(buf, "PNG", optimize=True)  # adaptive filters
    got = decode_png_channels(buf.getvalue())
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(buf.getvalue()))))


def test_kmeans_equals_jax():
    x = np.random.default_rng(2).standard_normal((2048, 45)).astype(np.float32)
    jc, jl = jpng._kmeans(x, 64)
    tc, tl = tpng._kmeans(x, 64, device="cpu")
    assert tl.dtype == np.int64 and tc.shape == (64, 45)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)


def _grid_energy(vecs, perm, S):
    """Mean squared difference of grid neighbours: what the sort lowers."""
    g = vecs[perm].reshape(S, S, -1).astype(np.float64)
    return float(((g[1:] - g[:-1]) ** 2).mean() + ((g[:, 1:] - g[:, :-1]) ** 2).mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_plas_permutation_equals_jax(seed):
    vecs = np.random.default_rng(seed).random((256, 14)).astype(np.float32)
    want = jplas.plas_sort_indices(vecs, 16, seed=seed)
    got = tplas.plas_sort_indices(vecs, 16, seed=seed, device="cpu")
    assert sorted(got.tolist()) == list(range(256))
    assert _grid_energy(vecs, got, 16) < 0.8 * _grid_energy(vecs, np.arange(256), 16)
    if np.array_equal(got, want):
        return
    # a float32 rounding of the blur or the distances flipped a swap: say so,
    # and hold the sorted grids to being as good as each other instead
    warnings.warn(f"PLAS seed {seed}: {(got != want).sum()} of 256 cells differ from JAX")
    assert abs(_grid_energy(vecs, got, 16) - _grid_energy(vecs, want, 16)) < 1e-6


def _splats(n=400, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        means=(3 * rng.standard_normal((n, 3))).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=rng.standard_normal((n, 3)).astype(np.float32) - 3,
        opacities=rng.standard_normal(n).astype(np.float32),
        sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
        shN=(0.3 * rng.standard_normal((n, 15, 3))).astype(np.float32),
    )


@pytest.mark.parametrize("method", ["morton", "plas"])
def test_compression_round_trips_across_the_packages(tmp_path, method):
    splats = _splats()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpng.PngCompression(sort_method=method).compress(jdir, splats)
    seconds = PngCompression(sort_method=method, device="cpu").compress(tdir, splats)
    assert set(seconds) == {"sort"} | set(splats)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    with open(os.path.join(jdir, "meta.json")) as f, open(os.path.join(tdir, "meta.json")) as g:
        assert json.load(g) == json.load(f)
    for d in (tdir, jdir):
        want = jpng.PngCompression().decompress(d)
        got = PngCompression().decompress(d)
        assert set(got) == set(want) == set(splats)
        for k in splats:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{d}: {k}")
    # the crop (400 = 20^2 keeps all), the quantisation steps, the sort
    out = PngCompression().decompress(tdir)
    ref = tpng.prepare_splats(splats, sort_method=method, device="cpu")
    for k in ("quats", "scales", "opacities", "sh0"):
        r = ref[k].reshape(400, -1)
        step = (r.max(axis=0) - r.min(axis=0)) / 255
        assert (np.abs(out[k].reshape(400, -1) - r) <= step / 2 + 1e-6).all(), k
    lm = tpng.log_transform(out["means"])
    step = (ref["means"].max(axis=0) - ref["means"].min(axis=0)) / 65535
    assert (np.abs(lm - ref["means"]) <= step / 2 + 1e-5).all()


def test_crop_drops_the_lowest_opacities():
    splats = _splats(n=403)
    ref = tpng.prepare_splats(splats, use_sort=False, device="cpu")
    keep = np.sort(splats["opacities"])[3:]
    assert len(ref["means"]) == 400
    np.testing.assert_array_equal(np.sort(ref["opacities"]), keep)


def test_compression_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PngCompression().compress(str(tmp_path), _splats())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplas.plas_sort_indices(np.zeros((4, 2), np.float32), 2)
    with pytest.raises(ValueError, match="sort method"):
        tpng.sort_splats(tpng.prepare_splats(_splats(), use_sort=False, device="cpu"), "zorder")
    assert jax.default_backend() == "cpu"  # the JAX side above ran on the CPU
