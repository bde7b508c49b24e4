"""Image resizing without PIL, as PIL resizes (numpy).

The JAX package's EndoNeRF trainer and NCore dataset resize through PIL's
`Image.resize`, which the card's machine lacks.  These repeat what Pillow
does (libImaging/Resample.c and Geometry.c):

  * `resize_bilinear_u8`: PIL's BILINEAR on uint8 images, a separable
    two-pass convolution (horizontal, then vertical) whose triangle filter's
    support grows with the factor when downsampling; each output's weights
    are normalised in double, turned into 22-bit fixed point, and each pass
    rounds and clips to 8 bits.
  * `resize_nearest`: PIL's NEAREST on any dtype: output pixel x takes the
    source pixel floor(x0 + (x + 0.5) * scale), the positions accumulated in
    double from the first one by adding the scale, as Pillow's affine scan
    does.
"""

from __future__ import annotations

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Resample.c's fixed point for 8-bit images


def _bilinear_coeffs(in_size: int, out_size: int):
    """(first source index [out], fixed-point weights [out, ksize]) of one
    axis (Resample.c:precompute_coeffs, normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = (xx + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # one tap at a time: the weights' sum in Pillow's order
        t = np.abs(((x + xmin) - center + 0.5) * ss)
        w = np.where((x < xmax) & (t < 1.0), 1.0 - t, 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    kk = np.trunc(0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass along `axis` of img [H, W, C] int64 (Resample.c:
    ImagingResampleHorizontal_8bpc / Vertical_8bpc)."""
    xmin, kk = _bilinear_coeffs(img.shape[axis], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]), img.shape[axis] - 1)
    taps = np.take(img, idx, axis=axis)  # [.., out, ksize, ..]
    w = kk.reshape((1,) * axis + kk.shape + (1,) * (img.ndim - axis - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + (taps * w).sum(axis=axis + 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def resize_bilinear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize((width, height), Image.BILINEAR)`
    on a uint8 image [H, W] or [H, W, C]."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear_u8 takes uint8 images, got {img.dtype}")
    x = img.astype(np.int64)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[1] != width:
        x = _pass(x, 1, width)
    if x.shape[0] != height:
        x = _pass(x, 0, height)
    out = x.astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output (Geometry.c:ImagingScaleAffine): the
    position starts at scale / 2 and adds the scale per output, in double."""
    scale = in_size / out_size
    pos = np.cumsum(np.concatenate([[scale * 0.5], np.full(out_size - 1, scale)]))
    return np.clip(np.trunc(pos).astype(np.int64), 0, in_size - 1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize((width, height), Image.NEAREST)`
    on an image [H, W] or [H, W, C] of any dtype."""
    return img[_nearest_index(img.shape[0], height)][:, _nearest_index(img.shape[1], width)]
