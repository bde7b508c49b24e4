"""The work counters on a hand-built scene whose live pairs are known."""

from __future__ import annotations

import torch

from benchmark.reference import splat3d
from benchmark.work import counts


def _fields(opacities):
    """Gaussians so wide over one 16x16 tile that alpha is their opacity at
    every pixel (clamped at 0.99), one behind the other."""
    n = len(opacities)
    f = torch.zeros(n, 9)
    f[:, 0:2] = 8.0
    f[:, 2] = f[:, 4] = 1e-9  # conic a, c: sigma ~ 0
    f[:, 5] = torch.tensor(opacities)
    f[:, 6:] = 0.5
    radii = torch.full((n, 2), 8.0)
    depths = torch.arange(1, n + 1, dtype=torch.float32)
    return f, splat3d.bin_tiles(f[:, :2], radii, depths, 16, 16)


def test_two_half_opaque_gaussians_are_both_live_at_every_pixel():
    f, bins = _fields([0.5, 0.5])
    img, alpha, live = splat3d.composite(f, bins, 16, 16)
    assert live == 2 * 256
    assert torch.allclose(alpha, torch.full((16, 16), 0.75))
    assert torch.allclose(img, torch.full((16, 16, 3), 0.5 * 0.75))


def test_the_gaussian_that_takes_T_to_the_threshold_is_not_live():
    """0.99 then 0.99: T would fall to 1e-4, so the second stops the pixel
    and is left out; the third is never reached."""
    f, bins = _fields([0.999, 0.999, 0.5])
    _, alpha, live = splat3d.composite(f, bins, 16, 16)
    assert live == 256
    assert torch.allclose(alpha, torch.full((16, 16), 0.99))


def test_counts_on_the_known_scene():
    ops, nbytes = counts.composite_forward(live=512, visible=2, pixels=256, D=3)
    assert ops == 512 * (21 + 6)
    assert nbytes == 2 * 9 * 2 + 256 * 4 * 4
    ops_b, _ = counts.composite_backward(live=512, visible=2, pixels=256, D=3)
    assert ops_b == 512 * ((29 + 9) + 9 + 21)
    w = dict(model="3dgs", live=512, visible=2, gaussians=2, pixels=256, channels=3)
    assert counts.request_flops(w) == 2 * 170 + 2 * 134 + 512 * 27
    assert counts.step_flops(w) == (counts.request_flops(w) + 2 * (170 + 134) + ops_b
                                    + 2 * 256 * 3 * 235 + 2 * 59 * 10)
    assert counts.least_seconds(67e12, 0) == 1.0 and counts.least_seconds(0, 3.35e12) == 1.0
