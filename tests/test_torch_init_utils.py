"""Port parity: gsplat_tpu_torch/init_utils.py against gsplat_tpu/init_utils.py
(points exact given the same seed, scales within 1e-6)."""

import numpy as np
import pytest

from gsplat_tpu import init_utils as jinit
from gsplat_tpu_torch import init_utils as tinit


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("max_points", [None, 500])
def test_multi_frame_depth_unprojection_matches(dtype, max_points):
    rng = np.random.default_rng(0)
    n, h, w = 3, 24, 32
    images = (rng.integers(0, 256, (n, h, w, 3)).astype(dtype) if dtype == np.uint8
              else rng.random((n, h, w, 3), np.float32))
    depths = rng.uniform(0.5, 4.0, (n, h, w)).astype(np.float32)
    depths[rng.random((n, h, w)) < 0.2] = 0.0
    masks = rng.random((n, h, w)) < 0.7
    masks[1] = False  # a frame with nothing to unproject
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    Ks = np.tile(np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32), (n, 1, 1))
    args = (images, depths, masks, poses, Ks)
    for seed in (0, 3):
        want = jinit.multi_frame_depth_unprojection(*args, max_points=max_points, seed=seed)
        got = tinit.multi_frame_depth_unprojection(*args, max_points=max_points, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    if max_points:
        assert len(got[0]) == max_points
    nothing = tinit.multi_frame_depth_unprojection(images, depths, np.zeros_like(masks), poses, Ks)
    assert nothing[0].shape == (0, 3)
    with pytest.raises(ValueError, match="leading dim mismatch"):
        tinit.multi_frame_depth_unprojection(images, depths[:2], masks, poses, Ks)


@pytest.mark.parametrize("k, init_scale", [(4, 1.0), (6, 0.5)])
def test_knn_scale_init_matches(k, init_scale):
    pts = np.random.default_rng(1).normal(size=(400, 3)).astype(np.float32)
    pts[7] = pts[8]  # a duplicate point: distance 0, clipped at 1e-7
    want = jinit.knn_scale_init(pts, k=k, init_scale=init_scale)
    got = tinit.knn_scale_init(pts, k=k, init_scale=init_scale)
    assert got.shape == (400, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
