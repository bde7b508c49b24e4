"""Port parity: segment_rowsum (K5) vs the JAX package's Pallas kernel.

Mirrors tests/test_segsum.py.  The same numpy data goes through
`gsplat_tpu.ops.segsum_pallas.segment_rowsum` (interpret mode) and the port
on the CPU (plain version).  Tolerance 1e-5 relative to the row's largest
sum: both add in float32; the Pallas kernel adds through split-bf16 matmuls
(~2**-18 per product), the port serially in slot order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.segsum_pallas import PIECE, SEG, segment_rowsum as jax_segment_rowsum
from gsplat_tpu_torch.ops.segsum_kernel import segment_rowsum, segment_rowsum_plain


def _both(data, bounds):
    F, P = data.shape
    E = len(bounds) - 1
    n_out = -(-E // SEG) * SEG
    f_pad = -(-F // 8) * 8
    jd = np.zeros((f_pad, P + 2 * PIECE), np.float32)
    jd[:F, :P] = data
    want = np.asarray(jax_segment_rowsum(jnp.asarray(jd), jnp.asarray(bounds), n_out=n_out,
                                         live_rows=F))[:F, :E]
    got = segment_rowsum(torch.from_numpy(data), torch.from_numpy(bounds)).numpy()
    return got, want


def _check(got, want, atol=1e-5):
    assert got.shape == want.shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("seed,E,F", [(0, 700, 9), (1, 1500, 11), (2, 40, 1)])
def test_matches_jax_on_random_runs(seed, E, F):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, E)
    lens[rng.random(E) < 0.3] = 0  # empty segments
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    P = int(bounds[-1]) + 37
    data = rng.standard_normal((F, P)).astype(np.float32)
    got, want = _both(data, bounds)
    _check(got, want)
    # and against a float64 sum
    ref = np.stack([[data[f, bounds[g]:bounds[g + 1]].astype(np.float64).sum()
                     for g in range(E)] for f in range(F)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_empty_segments_and_one_long_segment():
    rng = np.random.default_rng(3)
    bounds = np.array([0, 0, 0, 5000, 5000, 5003, 5003], np.int32)
    data = rng.standard_normal((9, 5100)).astype(np.float32)
    got, want = _both(data, bounds)
    # The Pallas kernel's 2-split bf16 products leave ~2**-18 of each of the
    # 5000 addends (|x| ~ 0.8): up to 1.5e-2 in all, ~4e-4 measured.  The port
    # is held to the exact serial float32 sum below.
    _check(got, want, atol=1e-4)
    assert (got[:, [0, 1, 3, 5]] == 0).all()
    # the long run is one serial float32 sum in slot order
    serial = np.add.accumulate(data[:, :5000], axis=1, dtype=np.float32)[:, -1]
    np.testing.assert_array_equal(got[:, 2], serial)


def test_garbage_past_the_last_bound_is_never_read():
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 6, 300)
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    P = int(bounds[-1]) + 600
    data = rng.standard_normal((9, P)).astype(np.float32)
    clean = segment_rowsum(torch.from_numpy(data), torch.from_numpy(bounds)).numpy()
    data[:, bounds[-1]:] = np.nan
    got, want = _both(data, bounds)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)
    _check(got, want)


def test_shapes_types_and_devices_are_checked():
    d = torch.zeros(3, 10)
    b = torch.tensor([0, 4, 10], dtype=torch.int32)
    assert segment_rowsum(d, b).shape == (3, 2)
    assert segment_rowsum(d, b[:1]).shape == (3, 0)
    assert segment_rowsum_plain(torch.zeros(3, 0), torch.zeros(4, dtype=torch.int32)).shape == (3, 3)
    with pytest.raises(ValueError, match="int32"):
        segment_rowsum(d, b.long())
    with pytest.raises(ValueError, match="float32"):
        segment_rowsum(d.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        segment_rowsum(torch.zeros(10, 3).t(), b)
    with pytest.raises(ValueError, match="several devices"):
        segment_rowsum(d, b.to("meta"))
    assert segment_rowsum.launches == 0  # the plain version counts nothing
