"""The early reject of the eval3d forward composite (csrc/ray3d.cuh, K7a): it
may gate a (pixel, slot) pair only where the exact path gates it.
`ray_certainly_gated_plain` is the reject in float32 with the kernel's
bound and margin: the mask of the pair's 8x4 block, which gates every
pixel of the block at once.  Here it is held to `_ray_batch`, the exact
path both plain versions use, on seeded scenes and on scenes built to sit
on its edges: opacities a few ulp around 1/255 and around the slot-wide
cut, pairs whose response sits at the gate or at the reject's own
boundary, pairs at hit_t = 0 and behind the ray's origin, flat, tiny and
huge scales, the 0.99 clamp, the OpenCV-radial rays of the 3DGUT phase,
rays with distinct origins (a rolling shutter and a moving lidar), and
NaN and infinity in dead slots and in rays.  No rejected pair may pass the
exact gate (exact: a single one fails).  The same scenes drive K7a on the
card in tests/test_torch_port_rules.py.

This file imports no JAX at its top, so that the card's test can build the
same scenes on a machine without it.
"""

import math

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops import rasterize as tr
from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as t3
from gsplat_tpu_torch.ops.projection_ut import fully_fused_projection_ut
from gsplat_tpu_torch.ops.rasterize_eval3d import iscl_rot_from_quat_scale
from gsplat_tpu_torch.sensors import generate_rays, make_camera
from gsplat_tpu_torch.sensors.cameras import RollingShutterType
from gsplat_tpu_torch.sensors.lidars import SpinningDirection, generate_lidar_rays, make_lidar

W, H, D = 64, 48, 4  # D: RGB and the hit distance, as the 3DGUT phase renders
HIT, NORMALS = True, True
RADIAL = (0.08, -0.02, 0.004)  # the 3DGUT phase's OpenCV radial coefficients
BOUNDARY_CASES = ("seeded", "opacity_edge", "gate_edge", "reject_edge", "hit_edge", "scales",
                  "clamp", "rolling", "lidar", "lidar_edge", "nonfinite")
ULP = 2.0 ** -23


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _gaussians(rng, N, depth=(2.0, 9.0), scale=(0.02, 0.3)):
    means = np.c_[rng.uniform(-1.8, 1.8, (N, 2)) * np.array([1.0, 0.75]), rng.uniform(*depth, N)]
    quats = rng.standard_normal((N, 4))
    scales = rng.uniform(*scale, (N, 3))
    op = rng.uniform(0.05, 1.0, N)
    return means, quats, scales, op


def _table(means, quats, scales, op, rng):
    """[E, 23] gaussian-major records: x, M, opacity, scale, 3 colours, the
    hit channel's input row, 3 normals."""
    N = means.shape[0]
    M = iscl_rot_from_quat_scale(_t(quats), _t(scales)).reshape(N, 9)
    nrm = torch.nn.functional.normalize(_t(rng.standard_normal((N, 3))), dim=1)
    return torch.cat([_t(means), M, _t(op)[:, None], _t(scales), _t(rng.random((N, D))), nrm], 1)


def _projected(means, quats, scales, op, rng, camera_kw=None):
    """Sorted slot fields, spans and rays of one distorted pinhole through
    the UT projection and the AABB emission, as the eval3d op hands them to
    K7a."""
    K = torch.tensor([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]])
    vm = torch.eye(4)[None]
    rad = torch.tensor([RADIAL])
    radii, m2, depths, _, _ = fully_fused_projection_ut(_t(means), _t(quats), _t(scales), _t(op),
                                                        vm, K, W, H, radial_coeffs=rad)
    cam = make_camera("pinhole", W, H, K[:, [0, 1], [0, 1]], K[:, :2, 2], radial_coeffs=rad)
    rays = generate_rays(cam, W, H, vm).contiguous()
    E = means.shape[0]
    tw, th = -(-W // 16), -(-H // 16)
    cap = 1 << 16
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    table = torch.where((plan.cnt > 0)[:, None], _table(means, quats, scales, op, rng), 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, cap, tw, th, 1)
    return fields.contiguous(), bounds, rays, (1, tw, th, W, H, HIT, NORMALS)


def _every_tile(table, depth, rays, width, height):
    """Every gaussian in every tile's span, nearest first: the fields and
    spans of a scene whose rays no projection of this repo tiles (a moving
    lidar), or whose pairs must all be evaluated."""
    order = torch.argsort(depth)
    tw, th = -(-width // 16), -(-height // 16)
    n_tiles = tw * th
    N = table.shape[0]
    fields = table[order].t().repeat(1, n_tiles).contiguous()
    bounds = (torch.arange(n_tiles + 1) * N).to(torch.int32)
    return fields, bounds, rays.contiguous(), (1, tw, th, width, height, HIT, NORMALS)


def _pair_batches(fields, bounds, rays, geo):
    """For every batch of tiles: the exact path (`_ray_batch`), the
    reject's verdict [nt, 256, L], the pairs the walk reaches, and the pairs
    of a pixel that starts and a slot in the span."""
    n_images, tw, th, width, height = geo[:5]
    for starts, counts, ids, L in t3._batches(bounds, n_images * tw * th, None, t3.PLAIN_BUDGET):
        rb = t3._ray_batch(fields, starts, counts, ids, L, rays, tw, tw * th, width, height, HIT)
        rej = t3.ray_certainly_gated_plain(rb.g[: t3.ROW_OP + 1], rays, ids, tw, tw * th, width,
                                           height)
        # the walk reaches a pair until its pixel stops (a kept pair that is not live)
        gate = rb.alpha > 0
        stopped = torch.cumsum((gate & ~rb.live).to(torch.int32), -1) - (gate & ~rb.live).int()
        d2 = t3._dot3(rb.d, rb.d)[..., 0]
        started = (rb.inside & (d2 > 1e-12))[..., None]
        reached = started & (stopped == 0) & rb.valid[:, None, :]
        yield rb, rej, reached, started & rb.valid[:, None, :]


def _set_op_at_pixels(fields, bounds, rays, geo, rng, shift):
    """Give each slot the opacity that puts one of its tile's pixels (one
    whose gray is below 40 and whose hit_t is not negative) at alpha =
    exp(-shift)/255, a few ulp either way: with shift 0 the pair sits on
    the exact gate, with shift delta on the reject's own boundary."""
    fields = fields.clone()
    for rb, _, _, _ in _pair_batches(fields, bounds, rays, geo):
        gray = t3._dot3(rb.c, rb.c)
        ok = (gray < 40.0) & (rb.hit_t >= 0) & rb.valid[:, None, :] & rb.inside[..., None]
        for t in range(gray.shape[0]):
            for j in torch.nonzero(rb.valid[t]).flatten().tolist():
                cand = torch.nonzero(ok[t, :, j]).flatten()
                if cand.numel() == 0:
                    continue
                p = int(cand[rng.integers(cand.numel())])
                k = int(rng.integers(-6, 7))
                op = math.exp(0.5 * float(gray[t, p, j]) - shift) / 255.0 * (1.0 + k * ULP)
                fields[t3.ROW_OP, int(rb.idx[t, j])] = op
    return fields


def _hit_edge(rng):
    """Gaussians whose centre sits where one pixel's ray has hit_t = 0
    (beside the camera, the whitened offset orthogonal to the ray), and a
    quarter behind the camera (hit_t < 0 at every pixel)."""
    N = 120
    K = torch.tensor([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]])
    cam = make_camera("pinhole", W, H, K[:, [0, 1], [0, 1]], K[:, :2, 2],
                      radial_coeffs=torch.tensor([RADIAL]))
    rays = generate_rays(cam, W, H, torch.eye(4)[None])
    means, quats, scales, op = _gaussians(rng, N, scale=(0.2, 0.8))
    R = iscl_rot_from_quat_scale(_t(quats), _t(scales)).reshape(N, 3, 3).double()
    for i in range(N):
        if i % 4 == 3:  # behind the camera
            means[i, 2] = -rng.uniform(0.5, 5.0)
            continue
        y, x = rng.integers(H), rng.integers(W)
        o, d = rays[0, y, x, :3].double(), rays[0, y, x, 3:].double()
        A = R[i].t() @ R[i]
        a = torch.from_numpy(rng.standard_normal(3))
        w = a - (a @ A @ d) / (d @ A @ d) * d  # (o - x) . A d = 0: hit_t = 0 at this pixel
        w = w / torch.sqrt(w @ A @ w) * rng.uniform(0.2, 2.5)  # gray of 0.04 to 6
        means[i] = (o + w).numpy()
    table = _table(means, quats, scales, op, rng)
    depth = _t(np.abs(means[:, 2]))
    return _every_tile(table, depth, rays[0][None], W, H)


def _rolling(rng):
    """A rolling-shutter camera moving 40 cm and turning 2 degrees over the
    frame (a car at 12 m/s, a 33 ms readout): every image row has its own
    origin."""
    means, quats, scales, op = _gaussians(rng, 200)
    K = torch.tensor([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]])
    cam = make_camera("pinhole", W, H, K[:, [0, 1], [0, 1]], K[:, :2, 2],
                      radial_coeffs=torch.tensor([RADIAL]),
                      shutter_type=RollingShutterType.ROLLING_TOP_TO_BOTTOM)
    vm = torch.eye(4)[None]
    vm_rs = torch.eye(4)[None]
    a = math.radians(2.0)
    vm_rs[0, :3, :3] = torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                     [-math.sin(a), 0, math.cos(a)]])
    vm_rs[0, :3, 3] = torch.tensor([0.4, 0.05, -0.1])
    rays = generate_rays(cam, W, H, vm, vm_rs)
    table = _table(means, quats, scales, op, rng)
    return _every_tile(table, _t(means[:, 2]), rays, W, H)


def _lidar(rng):
    """A 32 x 96 sector of a spinning lidar (0.25 degrees a column, 0.3 a
    row, as fine as a 64-beam lidar's) that moves 3 m and turns over the
    sector's sweep (each column its own origin: 25 cm across a block), among
    gaussians along its rays from 3 to 25 m."""
    rows, cols = 32, 96
    lidar = make_lidar(np.deg2rad(np.linspace(2.4, -7.0, rows)).astype(np.float32),
                       np.deg2rad(12.0 - 0.25 * np.arange(cols)).astype(np.float32),
                       np.zeros(rows, np.float32), SpinningDirection.CLOCKWISE, device="cpu")
    vm = torch.eye(4)[None]
    vm_rs = torch.eye(4)[None]
    a = math.radians(1.5)
    vm_rs[0, :3, :3] = torch.tensor([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0],
                                     [0, 0, 1]])
    vm_rs[0, :3, 3] = torch.tensor([3.0, 0.2, 0.0])
    rays = generate_lidar_rays(lidar, vm, vm_rs)
    N = 240
    at = rays[0, rng.integers(0, rows, N), rng.integers(0, cols, N)].double().numpy()
    r = rng.uniform(3.0, 25.0, N)
    means = at[:, :3] + at[:, 3:] * r[:, None] + rng.normal(0, 0.3, (N, 3))
    quats = rng.standard_normal((N, 4))
    scales = rng.uniform(0.05, 0.6, (N, 3))
    op = rng.uniform(0.05, 1.0, N)
    table = _table(means, quats, scales, op, rng)
    return _every_tile(table, _t(r), rays, cols, rows)


def boundary_scene(case: str):
    """(fields [23, P] f32, bounds, rays [1, H, W, 6], (n_images, tiles_w,
    tiles_h, W, H, hit, normals)) of one boundary case, on the CPU, from a
    fixed seed: the hit channel and the normals on, D = 4."""
    rng = np.random.default_rng(BOUNDARY_CASES.index(case) + 31)
    if case == "hit_edge":
        return _hit_edge(rng)
    if case == "rolling":
        return _rolling(rng)
    if case in ("lidar", "lidar_edge"):
        fields, bounds, rays, geo = _lidar(rng)
        if case == "lidar_edge":  # pairs on the exact gate, the origins apart within blocks
            fields = _set_op_at_pixels(fields, bounds, rays, geo, rng, 0.0)
        return fields, bounds, rays, geo
    means, quats, scales, op = _gaussians(rng, 300)
    if case == "scales":  # flat, tiny and huge gaussians beside each other
        kind = rng.integers(0, 3, means.shape[0])
        flat = np.c_[rng.uniform(0.2, 0.6, (means.shape[0], 2)), rng.uniform(1e-5, 1e-3, means.shape[0])]
        scales = np.where((kind == 0)[:, None], flat, scales)
        scales = np.where((kind == 1)[:, None], rng.uniform(1e-5, 1e-3, scales.shape), scales)
        scales = np.where((kind == 2)[:, None], rng.uniform(2.0, 40.0, scales.shape), scales)
        means[:, 2] = np.where(kind == 2, rng.uniform(20.0, 80.0, means.shape[0]), means[:, 2])
    elif case == "clamp":  # opaque: op * vis reaches 0.99 over most of each gaussian
        op = np.where(rng.random(op.shape) < 0.5, rng.uniform(0.985, 1.0, op.shape),
                      rng.uniform(1.0, 8.0, op.shape))
    fields, bounds, rays, geo = _projected(means, quats, scales, op, rng)
    n_sorted = int(bounds[-1])
    if case == "opacity_edge":  # half the slots around 1/255 and the slot-wide cut, +-4 ulp
        thr = np.float32(1.0 / 255.0)
        centres = np.array([thr, np.float32(t3.OP_DEAD)], np.float32)
        k = rng.integers(-4, 5, n_sorted)
        base = centres[rng.integers(0, 2, n_sorted)]
        edge = torch.from_numpy(rng.random(n_sorted) < 0.5)
        fields[t3.ROW_OP, :n_sorted] = torch.where(edge, torch.from_numpy(
            (base.astype(np.float64) * (1.0 + k * ULP)).astype(np.float32)),
            fields[t3.ROW_OP, :n_sorted])
    elif case == "gate_edge":
        fields = _set_op_at_pixels(fields, bounds, rays, geo, rng, 0.0)
    elif case == "reject_edge":
        fields = _set_op_at_pixels(fields, bounds, rays, geo, rng, t3.GATE_MARGIN)
    elif case == "nonfinite":  # dead slots with NaN and infinity; rays that are not finite
        dead = torch.from_numpy(rng.random(n_sorted) < 0.25)
        for i, c in enumerate(torch.nonzero(dead).flatten().tolist()):
            fields[t3.ROW_OP, c] = (0.0, math.nan)[i % 2]
            fields[int(rng.integers(0, t3.ROW_OP)), c] = (math.nan, math.inf, -math.inf)[i % 3]
        rays = rays.clone()
        rays[0, 5, 7, 3] = math.inf  # an active ray with an infinite direction
        rays[0, 20, 40, 0] = math.nan  # a NaN origin
        rays[0, 30, 9, 3:] = math.nan  # a NaN direction: the pixel starts at T = 0
        rays[0, 40, 50, 3:] = 0.0  # a zero ray: likewise
    return fields.contiguous(), bounds, rays.contiguous(), geo


def _tally(fields, bounds, rays, geo):
    """(pairs the reject gates that the exact path keeps or stops, pairs
    passing the exact gate, rejected pairs, gated pairs the walk reaches,
    of them rejected), over the pairs of a slot in the tile's span and a
    pixel that starts (inside the image, |d|^2 > 1e-12: any other pixel
    evaluates nothing)."""
    n_bad = n_pass = n_rej = n_gated = n_gated_rej = 0
    for rb, rej, reached, valid in _pair_batches(fields, bounds, rays, geo):
        passes = (rb.alpha > 0) & valid
        rej = rej & valid
        n_bad += int((passes & rej).sum())
        n_pass += int(passes.sum())
        n_rej += int(rej.sum())
        gated = reached & ~passes
        n_gated += int(gated.sum())
        n_gated_rej += int((gated & rej).sum())
    return n_bad, n_pass, n_rej, n_gated, n_gated_rej


@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_reject_never_gates_a_pair_the_exact_path_keeps(case):
    fields, bounds, rays, geo = boundary_scene(case)
    n_bad, n_pass, n_rej, _, _ = _tally(fields, bounds, rays, geo)
    assert n_bad == 0, f"{n_bad} pairs rejected that the exact path keeps or stops"
    assert n_pass > 0 and n_rej > 0, (n_pass, n_rej)


def test_gate_term_of_a_slot():
    """g = 2 (ln(255 op) + delta)(1 + s); -inf below the slot-wide cut, +inf
    with any non-finite row among x, M and the opacity, whatever the opacity."""
    rows = torch.ones(13, 8)
    thr = float(np.float32(1.0 / 255.0))
    rows[t3.ROW_OP] = torch.tensor([0.5, thr, t3.OP_DEAD, t3.OP_DEAD * (1 - ULP), 0.0, -1.0,
                                    math.nan, 0.5])
    rows[4, 7] = math.inf
    g = t3.ray_gate_plain(rows)
    want = 2.0 * (math.log(255.0 * 0.5) + t3.GATE_MARGIN) * t3.GATE_SLACK
    assert abs(float(g[0]) - want) <= 1e-6 * want
    assert 0.0 < float(g[1]) < 2.1 * t3.GATE_MARGIN and 0.0 < float(g[2]) < float(g[1])
    assert g[3:6].tolist() == [-math.inf] * 3
    assert g[6:].tolist() == [math.inf, math.inf]


def test_sigma_max_bounds_the_largest_singular_value():
    """The Gershgorin bound is at least M's largest singular value (float64
    SVD) on rotations of round, flat and needle-like gaussians and on rows
    that are not orthogonal, and within 1e-5 of it for a rotation."""
    rng = np.random.default_rng(4)
    N = 4000
    scales = np.exp(rng.uniform(-9, 4, (N, 3)))
    M = iscl_rot_from_quat_scale(_t(rng.standard_normal((N, 4))), _t(scales)).reshape(N, 9)
    skew = M + _t(rng.standard_normal((N, 9))) * M.abs().amax(1, keepdim=True) * 0.3
    for m, tight in ((M, True), (skew, False)):
        rows = torch.cat([torch.zeros(N, 3), m, torch.ones(N, 1)], 1).t()
        smax = t3.ray_sigma_max_plain(rows).double()
        sv = torch.linalg.svdvals(m.double().reshape(N, 3, 3))[:, 0]
        assert bool((smax >= sv).all())
        if tight:
            assert float((smax / sv - 1).max()) < 1e-5


@pytest.mark.parametrize("case", ["seeded", "rolling", "lidar", "nonfinite"])
def test_bundles_hold_every_active_ray(case):
    """Each block's bundle holds each active ray of the block in float64:
    its direction within `fit` of the affine model at its lane offset, its
    origin within ro of oc; ro is 0 where the block's origins are equal; a
    block with a ray that is not finite is not usable."""
    _, bounds, rays, geo = boundary_scene(case)
    n_images, tw, th, width, height = geo[:5]
    tiles = torch.arange(n_images * tw * th)
    bd = t3.ray_block_bundles_plain(rays, tiles, tw, tw * th, width, height)
    p = torch.arange(256)
    x = (tiles % tw)[:, None] * 16 + (p % 16)[None]
    y = (tiles // tw)[:, None] * 16 + (p // 16)[None]
    inside = (x < width) & (y < height)
    ray = torch.where(inside[..., None], rays[0][y.clamp(max=height - 1), x.clamp(max=width - 1)],
                      0.0)
    ray = t3._blocks_of(ray).double()  # [nt, 8, 32, 6]
    d = ray[..., 3:]
    active = t3._blocks_of(inside) & ((d.float() * d.float()).sum(-1) > 1e-12)
    finite = torch.isfinite(ray).all(-1)
    lane = torch.arange(32)
    w = active.double()
    n = w.sum(2).clamp(min=1.0)
    ox = (lane % 8)[None, None] - (w * (lane % 8)).sum(2, keepdim=True) / n[..., None]
    oy = (lane // 8)[None, None] - (w * (lane // 8)).sum(2, keepdim=True) / n[..., None]
    model = (bd.dc.double()[:, :, None] + ox[..., None] * bd.ax.double()[:, :, None]
             + oy[..., None] * bd.ay.double()[:, :, None])
    use = bd.usable[..., None] & active
    assert bool((ox.abs()[use] <= bd.ext_x.double()[..., None].expand_as(use)[use] + 1e-6).all())
    assert bool((oy.abs()[use] <= bd.ext_y.double()[..., None].expand_as(use)[use] + 1e-6).all())
    res = (d - model).norm(dim=-1)
    assert bool((res[use] <= bd.fit.double()[..., None].expand_as(use)[use]).all())
    dev_o = (ray[..., :3] - bd.oc.double()[:, :, None]).norm(dim=-1)
    assert bool((dev_o[use] <= bd.ro.double()[..., None].expand_as(use)[use]).all())
    assert not bool(bd.usable[(~finite & active).any(-1)].any())
    same = ((ray[..., :3] == bd.oc.double()[:, :, None]).all(-1) | ~active).all(-1)
    assert bool((bd.ro[same & bd.usable] == 0).all())
    if case == "seeded":  # a global shutter: one origin
        assert int(same.sum()) == int(active.any(-1).sum())
    elif case != "nonfinite":  # a moving sensor: origins differ within blocks
        assert int((bd.ro > 0).sum()) > 0


def test_reject_takes_most_gated_pairs_of_a_3dgut_scene():
    """On a 3DGUT scene (the distorted pinhole of the 3DGUT phase, 300
    gaussians at 64x48), the share of the gated pairs the walk reaches that
    the reject gates before the exact path: 69.8% of the 203,640 (81.5% lie
    in a block where the exact path gates every pixel, the most any block
    mask could take)."""
    fields, bounds, rays, geo = boundary_scene("seeded")
    n_bad, _, _, n_gated, n_gated_rej = _tally(fields, bounds, rays, geo)
    assert n_bad == 0
    share = n_gated_rej / n_gated
    assert share > 0.65, share
