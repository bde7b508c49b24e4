"""The early reject of the 2DGS composite (csrc/surfel.cuh), shared by K6a
and K6b: it may gate a (pixel, slot) pair only where the exact path gates
it.  `surfel_certainly_gated_plain` is the reject in float32 with the
kernels' gate term and margin: the mask of the pair's 8x4 block, which
gates every pixel of the block at once.  Here it is held to
`_surfel_batch`, the exact path both plain versions use, on seeded scenes
and on scenes built to sit on its edges: opacities a few ulp around 1/255 and around the
slot-wide cut, pixels whose response sits at the gate or at the reject's
own boundary, near-edge-on surfels, tiny and huge scales, the 0.99 clamp,
and NaN and infinity in dead slots.  No rejected pair may pass the exact
gate (exact: a single one fails).  The same scenes drive the kernels on
the card in tests/test_torch_port_rules.py.

This file imports no JAX at its top, so that the card's test can build the
same scenes on a machine without it.
"""

import math

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops import rasterize as tr
from gsplat_tpu_torch.ops import rasterize2d_kernel as t2
from gsplat_tpu_torch.ops.projection2d import fully_fused_projection_2dgs

W, H, D = 64, 48, 4
BOUNDARY_CASES = ("seeded", "opacity_edge", "gate_edge", "reject_edge", "edge_on", "scales",
                  "clamp", "nonfinite_dead")
ULP = 2.0 ** -23


def _fields(means, quats, scales, op, seed, width=W, height=H):
    """Sorted slot fields [15+D, P] and tile spans of one 80 px focal camera,
    as the 2DGS op hands them to K6a and K6b."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[[80.0, 0, width / 2], [0, 80.0, height / 2], [0, 0, 1]]])
    vm = torch.eye(4)[None]
    radii, m2, depths, M, nrm = fully_fused_projection_2dgs(means, quats, scales, vm, K, width,
                                                            height)
    E = means.shape[0]
    tw, th = -(-width // 16), -(-height // 16)
    cap = 1 << 16
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    table = torch.cat([m2.reshape(E, 2), M.reshape(E, 9), op[:, None],
                       torch.rand(E, D - 1, generator=g), depths.reshape(E, 1),
                       nrm.reshape(E, 3)], dim=1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, cap, tw, th, 1)
    return fields, bounds, (1, tw, th, width, height)


def _surfels(rng, N, depth=(3.0, 7.0), scale=(0.05, 0.5)):
    means = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)), rng.uniform(*depth, (N, 1))], 1)
    quats = rng.standard_normal((N, 4))
    scales = rng.uniform(*scale, (N, 3))
    return means, quats, scales


def _edge_on_quats(rng, N):
    """The surfel plane (local z = 0) turned to hold the viewing direction,
    give or take a milliradian: c_z is near 0 across the surfel."""
    ang = rng.uniform(0, 2 * np.pi, N)
    tilt = rng.uniform(-1e-3, 1e-3, N)
    # a quarter turn about the x axis, then a spin about the view axis
    half = (np.pi / 2 + tilt) / 2
    qx = np.stack([np.cos(half), np.sin(half), 0 * half, 0 * half], 1)
    qz = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], 1)
    w1, x1, y1, z1 = qz.T
    w2, x2, y2, z2 = qx.T
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)


def _pair_sigma(fields, bounds, geo):
    """For every tile: its batch of the exact path (`_surfel_batch`) and the
    response sigma of each (pixel, padded slot), with the kernels' rounding."""
    n_images, tw, th, width, height = geo
    for starts, counts, ids, L in t2._batches(bounds, n_images * tw * th, None, t2.PLAIN_BUDGET):
        sb = t2._surfel_batch(fields, starts, counts, ids, L, tw, tw * th, width, height)
        sigma2 = 2.0 * (sb.dx * sb.dx + sb.dy * sb.dy)
        sigma = 0.5 * torch.where(sb.use2d, sigma2, sb.sigma3)
        yield sb, sigma


def _set_op_at_pixels(fields, bounds, geo, rng, shift):
    """Give each slot the opacity that puts one of its tile's pixels (one
    whose response is below 20) at alpha = exp(-shift)/255, a few ulp
    either way: with shift 0 the pair sits on the exact gate, with shift
    delta on the reject's own boundary."""
    fields = fields.clone()
    for sb, sigma in _pair_sigma(fields, bounds, geo):
        s = torch.where(sb.valid[:, None, :] & (sigma < 20.0), sigma, torch.inf)  # [nt, n_pix, L]
        for t in range(s.shape[0]):
            for j in torch.nonzero(sb.valid[t]).flatten().tolist():
                ok = torch.nonzero(torch.isfinite(s[t, :, j])).flatten()
                if ok.numel() == 0:
                    continue
                p = int(ok[rng.integers(ok.numel())])
                k = int(rng.integers(-6, 7))
                op = math.exp(float(s[t, p, j]) - shift) / 255.0 * (1.0 + k * ULP)
                fields[t2.ROW_OP, int(sb.slot[t, 0, j])] = op
    return fields


def boundary_scene(case: str):
    """(fields [15+D, P] f32, bounds, (n_images, tiles_w, tiles_h, W, H)) of
    one boundary case, on the CPU, from a fixed seed."""
    rng = np.random.default_rng(BOUNDARY_CASES.index(case) + 11)
    N = 160
    means, quats, scales = _surfels(rng, N)
    op = rng.uniform(0.05, 1.0, N)
    if case == "edge_on":
        quats = _edge_on_quats(rng, N)
    elif case == "scales":  # sub-pixel surfels beside ones wider than the image
        scales = np.where(rng.random((N, 1)) < 0.5, rng.uniform(1e-5, 1e-3, (N, 3)),
                          rng.uniform(2.0, 40.0, (N, 3)))
        means[:, 2] = rng.uniform(2.0, 60.0, N)
    elif case == "clamp":  # face-on and opaque: op * vis reaches 0.99 over most of each surfel
        quats = np.tile([1.0, 0.0, 0.0, 0.0], (N, 1)) + rng.normal(0, 0.05, (N, 4))
        op = np.where(rng.random(N) < 0.5, rng.uniform(0.985, 1.0, N), rng.uniform(1.0, 8.0, N))
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    fields, bounds, geo = _fields(t(means), t(quats), t(scales), t(op), BOUNDARY_CASES.index(case))
    n_sorted = int(bounds[-1])
    if case == "opacity_edge":  # half the slots around 1/255 and the slot-wide cut, +-4 ulp
        thr = np.float32(1.0 / 255.0)
        centres = np.array([thr, np.float32(t2.OP_DEAD)], np.float32)
        k = rng.integers(-4, 5, n_sorted)
        base = centres[rng.integers(0, 2, n_sorted)]
        edge = torch.from_numpy(rng.random(n_sorted) < 0.5)
        fields[t2.ROW_OP, :n_sorted] = torch.where(edge, torch.from_numpy(
            (base.astype(np.float64) * (1.0 + k * ULP)).astype(np.float32)),
            fields[t2.ROW_OP, :n_sorted])
    elif case == "gate_edge":
        fields = _set_op_at_pixels(fields, bounds, geo, rng, 0.0)
    elif case == "reject_edge":
        fields = _set_op_at_pixels(fields, bounds, geo, rng, t2.GATE_MARGIN)
    elif case == "nonfinite_dead":  # a quarter of the slots: zero or NaN opacity, NaN and inf rows
        dead = torch.from_numpy(rng.random(n_sorted) < 0.25)
        cols = torch.nonzero(dead).flatten()
        for i, c in enumerate(cols.tolist()):
            fields[t2.ROW_OP, c] = (0.0, math.nan)[i % 2]
            row = int(rng.integers(0, t2.ROW_OP))
            fields[row, c] = (math.nan, math.inf, -math.inf)[i % 3]
    return fields.contiguous(), bounds, geo


def _pairs(fields, bounds, geo):
    """Over every tile: the exact path's verdict on each (pixel, slot) pair
    (passes the gate), the reject's, and whether the walk reaches the pair."""
    passes, rejected, reached = [], [], []
    for sb, _ in _pair_sigma(fields, bounds, geo):
        rows = sb.g[: t2.ROW_COLOR][:, :, None, :]  # [12, nt, 1, L]
        rej = t2.surfel_certainly_gated_plain(rows, sb.px, sb.py)
        valid = sb.valid[:, None, :].expand_as(rej)
        j = torch.arange(valid.shape[-1])
        passes.append((sb.alpha > 0)[valid])
        rejected.append(rej[valid])
        reached.append((j < sb.evaluated[..., None])[valid])
    return torch.cat(passes), torch.cat(rejected), torch.cat(reached)


@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_reject_never_gates_a_pair_the_exact_path_keeps(case):
    fields, bounds, geo = boundary_scene(case)
    passes, rejected, _ = _pairs(fields, bounds, geo)
    n_bad = int((passes & rejected).sum())
    assert n_bad == 0, f"{n_bad} pairs rejected that the exact path keeps or stops"
    assert int(passes.sum()) > 0 and int(rejected.sum()) > 0
    if case == "reject_edge":  # the opacities sit on the reject's boundary: both sides occur
        assert int((~passes & ~rejected).sum()) > 0
    if case == "edge_on":
        cz_small = 0
        for sb, _ in _pair_sigma(fields, bounds, geo):
            cz = torch.where(sb.cz_safe == 1.0, 0.0, sb.cz_safe)
            scale = sb.cx.abs() + sb.cy.abs()
            cz_small += int(((cz.abs() < 1e-3 * scale) & sb.valid[:, None, :]).sum())
        assert cz_small > 0


def test_gate_term_of_a_slot():
    """g = 2 (ln(255 op) + delta)(1 + s); -inf below the slot-wide cut, +inf
    with any non-finite response row, whatever the opacity."""
    rows = torch.ones(12, 8)
    thr = float(np.float32(1.0 / 255.0))
    rows[t2.ROW_OP] = torch.tensor([0.5, thr, t2.OP_DEAD, t2.OP_DEAD * (1 - ULP), 0.0, -1.0,
                                    math.nan, 0.5])
    rows[0, 7] = math.inf
    g = t2.surfel_gate_plain(rows)
    want = 2.0 * (math.log(255.0 * 0.5) + t2.GATE_MARGIN) * t2.GATE_SLACK
    assert abs(float(g[0]) - want) <= 1e-6 * want
    assert 0.0 < float(g[1]) < 2.1 * t2.GATE_MARGIN and 0.0 < float(g[2]) < float(g[1])
    assert g[3:6].tolist() == [-math.inf] * 3
    assert g[6:].tolist() == [math.inf, math.inf]


def _blocks(x):
    """[nt, 256 pixels, L] in a tile's row-major pixel order -> [nt, 8, 32,
    L], the tile's 8x4 blocks (two across, four down) and their pixels."""
    nt, _, L = x.shape
    return x.reshape(nt, 4, 4, 2, 8, L).permute(0, 1, 3, 2, 4, 5).reshape(nt, 8, 32, L)


def test_reject_gates_pairs_well_past_the_margin():
    """The reject has teeth: a block of pixels whose responses all sit at
    least twice the margin past ln(255 op) is masked in most cases (79.2%
    here; 91.8% where they sit 5 past it), the farther the more often, and a
    pair inside the margin never is.  The mask gates a block at once."""
    fields, bounds, geo = boundary_scene("seeded")
    far_at = {2 * t2.GATE_MARGIN: [0, 0], 5.0: [0, 0]}
    n_near = 0
    for sb, sigma in _pair_sigma(fields, bounds, geo):
        rows = sb.g[: t2.ROW_COLOR][:, :, None, :]
        rej = t2.surfel_certainly_gated_plain(rows, sb.px, sb.py)
        theta = torch.log(255.0 * rows[t2.ROW_OP].double())
        sigma2 = 2.0 * (sb.dx * sb.dx + sb.dy * sb.dy)
        lo = 0.5 * torch.minimum(sigma2, sb.sigma3).double()
        valid = sb.valid[:, None, :] & (sb.cz_safe.abs() > 1e-6)
        past = _blocks(torch.where(valid, lo - theta, -torch.inf)).amin(2)  # [nt, 8, L]
        blocked = _blocks(rej)
        assert bool((blocked.all(2) == blocked.any(2)).all()), "a mask gates its whole block"
        for k, tally in far_at.items():
            far = (past > k) & (past < 1e6)
            tally[0] += int(far.sum())
            tally[1] += int((far & blocked[:, :, 0]).sum())
        near = valid & (sigma.double() < theta + 0.5 * t2.GATE_MARGIN)
        assert not bool(rej[near].any())
        n_near += int(near.sum())
    (n_far, n_masked), (n_far5, n_masked5) = far_at.values()
    assert n_far > 1000 and n_near > 100, (n_far, n_near)
    assert n_masked / n_far > 0.75 and n_masked5 / n_far5 > n_masked / n_far, far_at


def test_reject_takes_most_gated_pairs_of_the_2dgs_scene():
    """On tests/test_2dgs.py's scene (both cameras), the share of the gated
    pairs the walk reaches that the reject gates before the exact path: most
    of them, though a surfel spans a good part of the 64x48 image here (92%
    of the gated pairs of the 2DGS step at 4k, PERF.md)."""
    from test_torch_projection2d import H as H2, W as W2, surfel_scene

    s = surfel_scene()
    args = [torch.from_numpy(s[k]) for k in ("means", "quats", "scales", "viewmats", "Ks")]
    radii, m2, depths, M, nrm = fully_fused_projection_2dgs(*args, W2, H2)
    C, N = m2.shape[:2]
    E = C * N
    tw, th = -(-W2 // 16), -(-H2 // 16)
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, 8192)
    op = torch.from_numpy(s["opacities"])[None].expand(C, N).reshape(E, 1)
    colors = torch.from_numpy(s["colors"])[None].expand(C, N, 3).reshape(E, 3)
    table = torch.cat([m2.reshape(E, 2), M.reshape(E, 9), op, colors, depths.reshape(E, 1),
                       nrm.reshape(E, 3)], 1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, 8192, tw, th, C)
    geo = (C, tw, th, W2, H2)
    passes, rejected, reached = _pairs(fields, bounds, geo)
    gated = reached & ~passes
    assert int((passes & rejected).sum()) == 0
    share = int((gated & rejected).sum()) / int(gated.sum())
    # 60.6% of the 340,657 gated pairs the walk reaches (85% of the 399,104 it reaches)
    assert share > 0.55, share
