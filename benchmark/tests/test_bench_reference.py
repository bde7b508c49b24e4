"""reference/ against the program's plain path, at a tiny size on the CPU.
Only the tests import both."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark.harness import scene as scene_mod
from benchmark.harness import traffic
from benchmark.models import gs3d
from benchmark.reference import splat3d, surfel2d
from benchmark.tests.tiny import tiny_cell
from gsplat_tpu_torch.rendering import rasterization


def test_reference_render_matches_the_programs_exact_path():
    c = tiny_cell("grid5-3dgs.serve-4k")
    cfg, mix = c.config, c.traffic
    p = scene_mod.make_scene(cfg, 3, "cpu")
    cams = traffic.cameras(mix, p["means"])
    kw = gs3d._render_kw(cfg)
    for v in range(len(cams.viewmats)):
        ref, ref_a, live, vis = splat3d.render(p, cams.viewmats[v], cams.K, mix["width"],
                                               mix["height"], kw, cfg["sh_degree"])
        img, alpha, _ = rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.cat([p["sh0"], p["shN"]], 1), cams.viewmats[v:v + 1], cams.K[None],
            mix["width"], mix["height"], sh_degree=cfg["sh_degree"], tile_size=16, **kw)
        assert live > 0 and vis > 0
        assert float((img[0] - ref).abs().max()) < 1e-5
        assert float((alpha[0, ..., 0] - ref_a).abs().max()) < 1e-5


@pytest.mark.parametrize("workload", ["grid5-3dgs.train-4k", "grid5-2dgs.train-4k"])
def test_reference_steps_match_the_programs_float32_trainer(workload):
    """Each trainer on its float32 path (3DGS without the bf16-pair
    carriers; 2DGS has no other) and the reference agree to round-off over
    the checked steps: losses, the first gradient's norms and each leaf's
    change."""
    c = tiny_cell(workload, exact=True)
    s = c.model.open_session(c.config, c.traffic, c.check, 11, "cpu")
    s.close()
    r = s.readings()
    assert r["loss_gap"] < 1e-6 and r["grad_gap"] < 1e-5 and r["change_gap"] < 1e-5, r
    assert r.get("grad_gap_facing", 0.0) < 1e-5, r


def test_facing_leaves_out_a_surfel_seen_nearly_edge_on():
    """Two visible surfels 5 units ahead: one faces the camera, the other
    is turned to a cosine of 0.005 with its ray."""
    th = math.acos(0.005)
    means = torch.tensor([[0.0, 0.1, 5.0], [0.0, -0.1, 5.0]])
    quats = torch.tensor([[1.0, 0, 0, 0], [math.cos(th / 2), 0, math.sin(th / 2), 0]])
    scales = torch.tensor([[0.1, 0.1, 1.0], [0.1, 0.1, 1.0]])
    vm, K = torch.eye(4), torch.tensor([[50.0, 0, 32], [0, 50, 32], [0, 0, 1]])
    p = surfel2d.project(means, quats, scales, vm, K, 64, 64, 0.01, 100.0)
    assert p.visible.tolist() == [True, True]
    assert surfel2d.facing(means, p, vm, 0.01).tolist() == [True, False]
    assert surfel2d.facing(means, p, vm, 0.001).tolist() == [True, True]
