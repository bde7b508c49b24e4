"""The 3DGUT configuration: its reference (reference/gut3d.py) against the
program's `rasterization(with_ut=True, with_eval3d=True)` on CPU tensors,
the reference's own semantics on a scene whose live pairs are known, its
imports, the work counts, and the cell resolving with its metrics."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import scene as scene_mod
from benchmark.harness import traffic
from benchmark.models import gs3d
from benchmark.reference import gut3d
from benchmark.tests.tiny import tiny_cell
from benchmark.work import counts, eval3d

CELL = "grid5-3dgut.train-4k"
NEW_METRICS = {"k7a_roofline.train", "k7b_roofline.train", "train_mfu.3dgut"}


def test_reference_forward_matches_the_programs_3dgut_render():
    """The tiny cell's scene through each orbit view of the distorting
    lens: the UT's radii equal, its means within 1e-2 pixel (the reference
    sums in float64, the program in float32 around a centre weight of -99:
    a float32 rounding of a 90-pixel point shows about a hundred times), the
    rays and the images to round-off."""
    from gsplat_tpu_torch.rendering import rasterization
    from gsplat_tpu_torch.sensors.cameras import generate_rays, make_camera

    c = tiny_cell(CELL)
    cfg, mix = c.config, c.traffic
    radial = tuple(cfg["trainer"]["radial_coeffs"])
    W, H = mix["width"], mix["height"]
    p = scene_mod.make_scene(cfg, 5, "cpu")
    cams = traffic.cameras(mix, p["means"])
    kw = gs3d._render_kw(cfg, train=True)
    op = torch.sigmoid(p["opacities"])
    for v in range(len(cams.viewmats)):
        vm = cams.viewmats[v]
        ref, ref_a, live, vis = gut3d.render(p, vm, cams.K, radial, W, H, kw, cfg["sh_degree"])
        img, alpha, meta = rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), op,
            torch.cat([p["sh0"], p["shN"]], 1), vm[None], cams.K[None], W, H,
            sh_degree=cfg["sh_degree"], with_ut=True, with_eval3d=True,
            radial_coeffs=torch.tensor([radial]), isect_capacity=1 << 16, **kw)
        proj = gut3d.ut_project(p["means"], p["quats"], torch.exp(p["scales"]), op, vm, cams.K,
                                radial, W, H, kw["near_plane"], kw["far_plane"],
                                kw["radius_clip"])
        assert live > 0 and vis > 0
        assert torch.equal(proj.radii, meta["radii"][0].float())
        shown = proj.visible
        assert float((proj.means2d[shown] - meta["means2d"][0][shown]).abs().max()) < 1e-2
        cam = make_camera("pinhole", W, H,
                          focal_lengths=torch.stack([cams.K[0, 0], cams.K[1, 1]])[None],
                          principal_points=cams.K[:2, 2][None],
                          radial_coeffs=torch.tensor([radial]))
        rays = generate_rays(cam, W, H, vm[None]).reshape(-1, 6)
        assert float((gut3d.camera_rays(vm, cams.K, radial, W, H) - rays).abs().max()) < 1e-5
        assert float((img[0] - ref).abs().max()) < 1e-4
        assert float((alpha[0, ..., 0] - ref_a).abs().max()) < 1e-4


def _wide(opacities, depth0=2.0):
    """Gaussians so wide across one 16x16 tile, one behind the other on the
    axis of a camera at the origin looking down +z, that alpha is their
    opacity at every pixel."""
    n = len(opacities)
    f = torch.zeros(n, gut3d.FIELDS)
    f[:, 2] = depth0 + torch.arange(n, dtype=torch.float32)
    f[:, 3:12] = (1e-6 * torch.eye(3)).reshape(9)  # M = diag(1/s) R^T, s = 1e6
    f[:, 12] = torch.tensor(opacities)
    f[:, 13:] = 0.5
    bins = gut3d.bin_tiles(torch.full((n, 2), 8.0), torch.full((n, 2), 8.0), f[:, 2], 16, 16)
    vm, K = torch.eye(4), torch.tensor([[16.0, 0, 8], [0, 16.0, 8], [0, 0, 1]])
    return f, bins, gut3d.camera_rays(vm, K, (), 16, 16)


def test_two_half_opaque_gaussians_are_both_live_at_every_pixel():
    f, bins, rays = _wide([0.5, 0.5])
    img, alpha, live = gut3d.composite(f, bins, rays, 16, 16)
    assert live == 2 * 256
    assert torch.allclose(alpha, torch.full((16, 16), 0.75))
    assert torch.allclose(img, torch.full((16, 16, 3), 0.5 * 0.75))


def test_the_gaussian_that_takes_T_to_the_threshold_is_not_live_nor_one_behind_the_ray():
    """0.99 then 0.99 stops the pixel at the second, which is left out; a
    gaussian whose peak lies behind the ray's origin is skipped."""
    f, bins, rays = _wide([0.999, 0.999, 0.5])
    _, alpha, live = gut3d.composite(f, bins, rays, 16, 16)
    assert live == 256 and torch.allclose(alpha, torch.full((16, 16), 0.99))
    f, bins, rays = _wide([0.5], depth0=-3.0)
    _, alpha, live = gut3d.composite(f, bins, rays, 16, 16)
    assert live == 0 and float(alpha.abs().max()) == 0.0


def test_the_reference_imports_nothing_of_the_program_jax_or_a_kernel():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import benchmark.reference.gut3d, benchmark.reference.train_gut, "
            "benchmark.work.eval3d\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gsplat_tpu_torch', 'gsplat_tpu', 'jax', 'jaxlib', 'triton'})))"
            % str(cell_mod.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=cell_mod.ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_the_cell_resolves_with_its_metrics():
    c = cell_mod.resolve(CELL)
    assert c.config["model"] == "gut3d" and c.chips == 1
    assert c.config["trainer"]["with_ut"] and c.config["trainer"]["with_eval3d"]
    assert {m.name for m in c.end_to_end} == {"train_steps_per_s", "peak_mem_gib", "setup_s"}
    names = {m.name for m in c.per_layer}
    assert NEW_METRICS | {"device_idle_share.train", "launches_per_step.train"} == names
    for other in ("grid5-3dgs.train-4k", "grid5-2dgs.train-4k", "grid5-3dgs.serve-4k"):
        assert not NEW_METRICS & {m.name for m in cell_mod.resolve(other).per_layer}


def test_counts_and_readers_on_a_known_step():
    assert eval3d.composite_forward(live=512, visible=2, pixels=256, D=3) == (
        512 * (48 + 7), 2 * 16 * 4 + 256 * 10 * 4)
    assert eval3d.k7b_flop_per_live_pair(3) == 6 + 75 + 16
    w = dict(model="3dgut", live=512, visible=2, gaussians=3, pixels=256, channels=3)
    assert eval3d.step_flops(w) == (3 * 423 + 2 * (12 + 134) + 512 * 55
                                    + 2 * (42 + 134) + 512 * (48 + 97)
                                    + 2 * 256 * 3 * 235 + 2 * 59 * 10)
    c = cell_mod.resolve(CELL)
    readers = {m.name: m.read for m in c.per_layer}
    trace = SimpleNamespace(op_seconds={"void (anonymous namespace)::rasterize_eval3d_fwd_"
                                        "kernel<3, false>(float const*)": 1e-3},
                            window_s=0.1)
    ctx = SimpleNamespace(trace=trace, work=[w])
    least = counts.least_seconds(*eval3d.composite_forward(512, 2, 256, 3))
    assert readers["k7a_roofline.train"](ctx) == 100.0 * least / 1e-3
    assert readers["k7b_roofline.train"](ctx) is None  # no K7b in that trace
    assert readers["train_mfu.3dgut"](ctx) == 100.0 * eval3d.step_flops(w) / (0.1 * 67e12)
