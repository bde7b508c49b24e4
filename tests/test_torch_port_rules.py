"""Rules of the PyTorch port: no JAX, the card by default, no silent
options, and (on a card only) each CUDA kernel against its plain version."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch.ops import rasterize as tr
from gsplat_tpu_torch.scene import (
    GaussianInferenceScene,
    load_checkpoint,
    render_scene,
    splats_from_numpy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gsplat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "simple_trainer_torch.py",
    ROOT / "examples" / "simple_trainer_2dgs_torch.py", ROOT / "examples" / "av_trainer_torch.py",
    ROOT / "examples" / "sample_inference_torch.py", ROOT / "examples" / "simple_viewer_torch.py",
    ROOT / "examples" / "image_fitting_torch.py",
    ROOT / "examples" / "dynamic_surgical_trainer_torch.py",
    ROOT / "studies" / "k3_expand_rows.py", ROOT / "studies" / "colmap_steps.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "gsplat_tpu"), f"{path} imports {name}"


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_has_no_try_around_a_build_or_a_launch(path):
    """A wrapper launches its kernel or raises; nothing catches a failed
    build or launch and takes another route.  The package needs no `try` at
    all, so none is allowed."""
    tries = [n.lineno for n in ast.walk(ast.parse(path.read_text(), str(path)))
             if isinstance(n, ast.Try)]
    assert not tries, f"{path}: try statement at lines {tries}"


def _splats(N=20, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "means": rng.uniform(-1, 1, (N, 3)),
        "quats": rng.standard_normal((N, 4)),
        "scales": np.log(rng.uniform(0.05, 0.1, (N, 3))),
        "opacities": rng.normal(size=(N,)),
        "sh0": rng.standard_normal((N, 1, 3)),
        "shN": np.zeros((N, 3, 3)),
    }


def test_scene_loaders_default_to_the_card(monkeypatch, tmp_path):
    """With no card and no device named, the entry points raise instead of
    running on the CPU; device='cpu' runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        splats_from_numpy(_splats())
    path = tmp_path / "ckpt.npz"
    np.savez(path, **{f"p_{k}": v for k, v in _splats().items()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(str(path))
    scene = load_checkpoint(str(path), device="cpu")
    assert scene.splats["means"].device.type == "cpu" and scene.alive is None


def _small_call(**kw):
    rng = np.random.default_rng(0)
    N = 10
    means = torch.from_numpy(rng.uniform(-1, 1, (N, 3)).astype(np.float32))
    means[:, 2] += 4.0
    quats = torch.from_numpy(rng.standard_normal((N, 4)).astype(np.float32))
    scales = torch.full((N, 3), 0.1)
    opac = torch.full((N,), 0.5)
    colors = torch.rand(N, 3, generator=torch.Generator().manual_seed(0))
    K = torch.tensor([[[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]]])
    return rasterization(means, quats, scales, opac, colors, torch.eye(4)[None], K, 32, 32, **kw)


@pytest.mark.parametrize(
    "option",
    [
        # the eval3d composite carries no screen-space gradient
        dict(absgrad=True, means2d_offset=torch.zeros(1, 10, 2), with_ut=True, with_eval3d=True),
        dict(means2d_offset=torch.zeros(1, 10, 2), with_ut=True, with_eval3d=True),
        dict(with_eval3d=True, rasterize_mode="antialiased"),
        dict(with_ut=True, rasterize_mode="antialiased"),
        dict(radial_coeffs=torch.zeros(1, 6)),
        dict(rolling_shutter="rolling"),
        dict(rays=torch.zeros(1, 32, 32, 6)),
        dict(render_mode="RGB-d"),
        dict(camera_model="lidar"),
        dict(with_eval3d=True, pack_payload=True),
        dict(with_eval3d=True, masks=torch.ones(1, 2, 2, dtype=torch.bool)),
        dict(with_eval3d=True, tile_size=8),
        # the fast path is inference-only and colour-only (rendering.py:586-599)
        dict(fast=True, absgrad=True, means2d_offset=torch.zeros(1, 10, 2)),
        dict(fast=True, masks=torch.ones(1, 2, 2, dtype=torch.bool)),
        *(pytest.param(dict(fast=True, render_mode=m), id=f"fast+render_mode={m}")
          for m in ("D", "ED", "RGB+D", "RGB+ED")),
        pytest.param(dict(fast=True, render_mode="D", with_ut=True),
                     id="fast+render_mode=D+with_ut"),
    ],
    ids=lambda o: "+".join(o),
)
def test_options_the_jax_package_refuses_raise_value_errors(option):
    if option.get("rolling_shutter") == "rolling":
        from gsplat_tpu_torch.sensors import RollingShutterType
        option = dict(option, rolling_shutter=RollingShutterType.ROLLING_TOP_TO_BOTTOM)
    with pytest.raises(ValueError):
        _small_call(**option)


def test_batched_eval3d_raises():
    rng = np.random.default_rng(0)
    means = torch.from_numpy(rng.uniform(-1, 1, (2, 10, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="unbatched"):
        rasterization(means, torch.randn(2, 10, 4), torch.full((2, 10, 3), 0.1),
                      torch.full((2, 10), 0.5), torch.rand(2, 10, 3), torch.eye(4).expand(2, 1, 4, 4),
                      torch.eye(3).expand(2, 1, 3, 3), 32, 32, with_ut=True, with_eval3d=True)


def test_in_slice_call_and_backward_raises():
    c, a, meta = _small_call()
    assert c.shape == (1, 32, 32, 3) and float(a.max()) > 0
    assert not bool(meta["isect_overflow"])
    # The backward no longer raises: the training slice gave the autograd
    # Function its kernels.  What still raises in a backward call is a
    # cotangent on another device than the saved forward tensors.
    colors = torch.rand(1, 10, 3, requires_grad=True)
    m2 = torch.full((1, 10, 2), 16.0)
    cn = torch.tensor([0.1, 0.0, 0.1]).repeat(1, 10, 1)
    out, _, _ = tr.rasterize_to_pixels(
        m2, cn, colors, torch.full((1, 10), 0.5), 32, 32,
        torch.full((1, 10, 2), 5, dtype=torch.int32), torch.ones(1, 10), 512,
    )
    out.sum().backward()
    assert torch.isfinite(colors.grad).all() and float(colors.grad.abs().max()) > 0
    from gsplat_tpu_torch.ops.rasterize_kernel import rasterize_bwd
    z = torch.zeros
    with pytest.raises(ValueError, match="several devices"):
        rasterize_bwd(z(9, 8), z(2, dtype=torch.int32), 1, 16, 1, 1, 16, 16,
                      z(1, 16, 16, 3, device="meta"), z(1, 16, 16), z(1, 16, 16, 3), z(1, 16, 16))


def test_render_scene_fast_raises_and_depth_modes_take_the_exact_path():
    """render_scene takes the fast path for RGB by default (no autograd, no
    AABB tile counts), the exact path for depth modes; a released scene
    raises."""
    sp = _splats()
    scene = splats_from_numpy(sp, device="cpu")
    inf = GaussianInferenceScene.from_gaussian_scene(scene, id="s")
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 4.0
    K = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]], np.float32)
    c, a, meta = render_scene(inf, viewmat=vm, K=K, width=32, height=32)
    assert c.shape == (1, 32, 32, 3) and float(a.max()) > 0
    assert (meta["tiles_per_gauss"] == 0).all()  # the fast path's meta
    c, a, meta = render_scene(inf, viewmat=vm, K=K, width=32, height=32, render_mode="D")
    assert c.shape == (1, 32, 32, 1) and meta["render_path"] == "inference"
    assert int(meta["tiles_per_gauss"].sum()) > 0  # the exact path
    inf.release()
    with pytest.raises(ValueError, match="released"):
        render_scene(inf, viewmat=vm, K=K, width=32, height=32)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 4, 32])
def test_kernels_match_plain_versions_on_the_card(D):
    """Each CUDA kernel against its plain version on the same CUDA inputs
    (D = 32 at tile 32 stages more than 48 KB of shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import gather_kernel as tg
    from gsplat_tpu_torch.ops import rasterize_kernel as tk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    I, N, Wd, Hd = 2, 3000, 200, 150
    m2 = torch.rand(I, N, 2, generator=g, device=dev) * torch.tensor([Wd, Hd], device=dev)
    a = torch.rand(I, N, generator=g, device=dev) * 0.5 + 0.02
    c = torch.rand(I, N, generator=g, device=dev) * 0.5 + 0.02
    b = (torch.rand(I, N, generator=g, device=dev) - 0.5) * torch.sqrt(a * c)
    cn = torch.stack([a, b, c], -1)
    cl = torch.rand(I, N, D, generator=g, device=dev)
    op = torch.rand(I, N, generator=g, device=dev)
    dep = torch.rand(I, N, generator=g, device=dev) + 0.5
    rad = torch.full((I, N, 2), 12, dtype=torch.int32, device=dev)
    for ts in (8, 16, 32):
        tw, th = -(-Wd // ts), -(-Hd // ts)
        T = I * tw * th
        comp = tr.compact_by_depth(m2, cn, cl, op, rad, dep)
        geo = tr.row_geometry(comp.means2d, comp.radii, comp.conics, comp.opacities,
                              comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 17)
        got = tg.expand_rows(geo.gg_f, geo.gg_i, geo.n_rows, 1 << 17, ts, I)
        want = tg.expand_rows_plain(geo.gg_f, geo.gg_i, geo.n_rows, 1 << 17, ts, I)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        plan = tr.make_tight_plan(comp.means2d, comp.radii, comp.conics, comp.opacities,
                                  comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 18, 1 << 17,
                                  with_slot_bounds=True)
        assert not bool(plan.overflow)
        table = tr.field_table(comp, plan.dummy)
        args = (plan.rr, table, plan.n_slots, 1 << 18, tw, tw * th, T)
        keys, fields = tg.expand_emission(*args)
        keys_p, fields_p = tg.expand_emission_plain(*args)
        assert torch.equal(keys, keys_p) and torch.equal(fields, fields_p)
        fs, bounds, order = tr.sort_slots(keys, fields, T)
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        col, t = tk.rasterize_fwd(fs, bounds, I, ts, tw, th, Wd, Hd, pair_counts=kept)
        col_p, t_p = tk.rasterize_fwd_plain(fs, bounds, I, ts, tw, th, Wd, Hd)
        torch.cuda.synchronize()
        # exp ulps and the order of the colour sums differ: 1e-4 absolute
        assert (col - col_p).abs().max().item() <= 1e-4
        assert (t - t_p).abs().max().item() <= 1e-4

        # K2 on the forward's own outputs: the replay decides as the forward did
        v_pix = torch.randn(col.shape, generator=g, device=dev)
        v_t = torch.randn(t.shape, generator=g, device=dev)
        live = torch.empty(T, dtype=torch.int32, device=dev)
        bwd_args = (fs, bounds, I, ts, tw, th, Wd, Hd, v_pix, v_t, col, t)
        v_slot = tk.rasterize_bwd(*bwd_args, live_counts=live)
        v_slot_p, n_live_p = tk.rasterize_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
        assert int(live.sum()) == n_live_p > 0
        assert torch.equal(v_slot, tk.rasterize_bwd(*bwd_args)), "two runs differ"
        # the order of the sum over a tile's pixels differs: 1e-4 of the row's scale
        for row, row_p in zip(v_slot, v_slot_p):
            scale = max(1.0, row_p.abs().max().item())
            assert (row - row_p).abs().max().item() <= 1e-4 * scale
        assert (v_slot[:, int(bounds[-1]):] == 0).all()

        # K5 on K2's output in emission order, over the plan's boundaries
        from gsplat_tpu_torch.ops import segsum_kernel as tsg
        v_emit = torch.empty_like(v_slot).index_copy_(1, order, v_slot)
        vg = tsg.segment_rowsum(v_emit, plan.slot_bounds)
        vg_p = tsg.segment_rowsum_plain(v_emit, plan.slot_bounds)
        torch.cuda.synchronize()
        # both add a segment serially in slot order, each add a float32 add
        assert torch.equal(vg, vg_p)
        assert torch.equal(vg, tsg.segment_rowsum(v_emit, plan.slot_bounds))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 3, 4, 32])
def test_packed_kernels_match_plain_versions_on_the_card(D):
    """K4 packed and K1 packed bit for bit against their plain versions, K2 in
    its packed modes (payload, gradients, both) within 1e-5 of each row's
    largest entry (after unpacking; one bf16 ulp per carrier half where the
    kernel's and the plain version's sums round to neighbouring bf16
    values), with the forward's contributing pairs as its live pairs.  Some
    colours are bf16 ties, f32 denormals and -0, which every rounding of the
    carriers must keep alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import bf16pair as tb
    from gsplat_tpu_torch.ops import gather_kernel as tg
    from gsplat_tpu_torch.ops import rasterize_kernel as tk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    I, N, Wd, Hd = 2, 3000, 200, 150
    m2 = torch.rand(I, N, 2, generator=g, device=dev) * torch.tensor([Wd, Hd], device=dev)
    a = torch.rand(I, N, generator=g, device=dev) * 0.5 + 0.02
    c = torch.rand(I, N, generator=g, device=dev) * 0.5 + 0.02
    b = (torch.rand(I, N, generator=g, device=dev) - 0.5) * torch.sqrt(a * c)
    cn = torch.stack([a, b, c], -1)
    cl = torch.rand(I, N, D, generator=g, device=dev)
    edges = torch.tensor([1e-40, -0.0, 0.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, -1e-39], device=dev)
    cl[0, :6, 0] = edges
    op = torch.rand(I, N, generator=g, device=dev)
    dep = torch.rand(I, N, generator=g, device=dev) + 0.5
    rad = torch.full((I, N, 2), 12, dtype=torch.int32, device=dev)
    R = tb.packed_rows(D)
    for ts in (8, 16, 32):
        tw, th = -(-Wd // ts), -(-Hd // ts)
        T = I * tw * th
        comp = tr.compact_by_depth(m2, cn, cl, op, rad, dep)
        plan = tr.make_tight_plan(comp.means2d, comp.radii, comp.conics, comp.opacities,
                                  comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 18, 1 << 17)
        table = tr.field_table(comp, plan.dummy)
        args = (plan.rr, table, plan.n_slots, 1 << 18, tw, tw * th, T)
        launched = tg.expand_emission.launches_packed
        keys, fields = tg.expand_emission(*args, packed=True, tile_size=ts)
        keys_p, fields_p = tg.expand_emission_plain(*args, packed=True, tile_size=ts)
        assert tg.expand_emission.launches_packed == launched + 1
        assert fields.shape == (R, 1 << 18)
        assert torch.equal(keys, keys_p)
        assert torch.equal(fields.view(torch.int32), fields_p.view(torch.int32))
        fs, bounds, _ = tr.sort_slots(keys, fields, T)
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        geo = (I, ts, tw, th, Wd, Hd)
        col, t = tk.rasterize_fwd(fs, bounds, *geo, pair_counts=kept, packed=True, n_channels=D)
        col_p, t_p = tk.rasterize_fwd_plain(fs, bounds, *geo, packed=True, n_channels=D)
        torch.cuda.synchronize()
        assert torch.equal(col, col_p) and torch.equal(t, t_p)
        assert int(kept.sum()) > 0

        v_pix = torch.randn(col.shape, generator=g, device=dev)
        v_t = torch.randn(t.shape, generator=g, device=dev)
        for packed, pack_grads in ((True, False), (True, True), (False, True)):
            fields_in = fs
            if not packed:  # pack_grads alone: the float32 slot rows
                k32, f32 = tg.expand_emission(*args)
                fields_in, bounds_in, _ = tr.sort_slots(k32, f32, T)
                out32 = tk.rasterize_fwd(fields_in, bounds_in, *geo, pair_counts=kept)
                bargs = (fields_in, bounds_in, *geo, v_pix, v_t, *out32)
            else:
                bargs = (fs, bounds, *geo, v_pix, v_t, col, t)
            modes = dict(packed=packed, pack_grads=pack_grads, n_channels=D)
            live = torch.empty(T, dtype=torch.int32, device=dev)
            v_slot = tk.rasterize_bwd(*bargs, live_counts=live, **modes)
            v_slot_p, n_live_p = tk.rasterize_bwd_plain(*bargs, **modes)
            torch.cuda.synchronize()
            assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
            assert int(live.sum()) == n_live_p > 0
            again = tk.rasterize_bwd(*bargs, **modes)
            assert torch.equal(v_slot.view(torch.int32), again.view(torch.int32)), "two runs differ"
            n_sorted = int(bargs[1][-1])
            assert (v_slot.view(torch.int32)[:, n_sorted:] == 0).all()
            if pack_grads:
                assert v_slot.shape[0] == tb.grad_pack_rows(D)
                got, want = tb.unpack_rows(v_slot, 6 + D), tb.unpack_rows(v_slot_p, 6 + D)
                # one bf16 ulp (at most 2^-7 of the value) per half, else the
                # row tolerance
                ulp = 2.0**-7 * torch.maximum(got.abs(), want.abs())
            else:
                got, want, ulp = v_slot, v_slot_p, torch.zeros_like(v_slot)
            for row, row_p, u in zip(got, want, ulp):
                scale = row_p.abs().max().item()
                allowed = torch.clamp(u, min=1e-5 * scale)
                assert bool(((row - row_p).abs() <= allowed).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_spans", "all_stop", "lead_and_tail"])
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_k2_stress_cases_on_the_card(case, ts):
    """K2 (float32 and packed with pack_grads) where its batches, early
    exit and zero writes are stressed: spans of many 64-slot batches,
    pixels that all stop within the first batches (the CTA leaves and zeroes
    the rest of its span), and slots outside every span before the first
    tile's and after the last (each CTA zeroes its share).  The output is
    allocated uncleared and filled with NaN first, so a slot no CTA writes
    shows.  Live pairs equal the forward's, two runs give the same bits, the
    rows are within the tolerances of the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import bf16pair as tb
    from gsplat_tpu_torch.ops import rasterize_kernel as tk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    I, Wd, Hd, D = 1, 100, 70, 3
    N = {"long_spans": 6000, "all_stop": 3000, "lead_and_tail": 2000}[case]
    m2 = torch.rand(I, N, 2, generator=g, device=dev) * torch.tensor([Wd, Hd], device=dev)
    a = torch.rand(I, N, generator=g, device=dev) * 0.05 + 0.005
    c = torch.rand(I, N, generator=g, device=dev) * 0.05 + 0.005
    b = (torch.rand(I, N, generator=g, device=dev) - 0.5) * torch.sqrt(a * c)
    cn = torch.stack([a, b, c], -1)
    cl = torch.rand(I, N, D, generator=g, device=dev)
    op = torch.rand(I, N, generator=g, device=dev) * (0.2 if case == "long_spans" else 1.0)
    if case == "all_stop":
        op = torch.full_like(op, 0.98)
    dep = torch.rand(I, N, generator=g, device=dev) + 0.5
    rad = torch.full((I, N, 2), 40, dtype=torch.int32, device=dev)
    tw, th = -(-Wd // ts), -(-Hd // ts)
    T = I * tw * th
    comp = tr.compact_by_depth(m2, cn, cl, op, rad, dep)
    plan = tr.make_tight_plan(comp.means2d, comp.radii, comp.conics, comp.opacities,
                              comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 19, 1 << 17)
    assert not bool(plan.overflow)
    table = tr.field_table(comp, plan.dummy)
    from gsplat_tpu_torch.ops import gather_kernel as tg

    keys, fields = tg.expand_emission(plan.rr, table, plan.n_slots, 1 << 19, tw, tw * th, T)
    fs, bounds, _ = tr.sort_slots(keys, fields, T)
    lead = 37 if case == "lead_and_tail" else 0
    if lead:  # slots before the first span: junk rows that no tile reads
        fs = torch.cat([torch.full((fs.shape[0], lead), float("nan"), device=dev), fs], 1)
        bounds = bounds + lead
    spans = bounds[1:] - bounds[:-1]
    if case == "long_spans":
        assert int(spans.max()) > 6 * 64
    geo = (I, ts, tw, th, Wd, Hd)
    kept = torch.empty(T, dtype=torch.int32, device=dev)
    col, t = tk.rasterize_fwd(fs, bounds, *geo, pair_counts=kept)
    v_pix = torch.randn(col.shape, generator=g, device=dev)
    v_t = torch.randn(t.shape, generator=g, device=dev)
    bargs = (fs, bounds, *geo, v_pix, v_t, col, t)
    n_sorted = int(bounds[-1])
    for pack_grads in (False, True):
        modes = dict(pack_grads=pack_grads)
        live = torch.empty(T, dtype=torch.int32, device=dev)
        torch.empty(1 << 28, device=dev).fill_(float("nan"))  # the allocator's next blocks
        v_slot = tk.rasterize_bwd(*bargs, live_counts=live, **modes)
        again = tk.rasterize_bwd(*bargs, **modes)
        v_slot_p, n_live_p = tk.rasterize_bwd_plain(*bargs, **modes)
        torch.cuda.synchronize()
        assert torch.equal(live, kept) and int(live.sum()) == n_live_p > 0
        assert torch.equal(v_slot.view(torch.int32), again.view(torch.int32)), "two runs differ"
        outside = torch.cat([v_slot[:, :lead], v_slot[:, n_sorted:]], 1)
        assert (outside.view(torch.int32) == 0).all(), "a slot outside every span is not zero"
        if case == "all_stop":
            assert int(live.sum()) < int(spans.sum()) * ts * ts // 8
        if pack_grads:
            got, want = tb.unpack_rows(v_slot, 6 + D), tb.unpack_rows(v_slot_p, 6 + D)
            ulp = 2.0**-7 * torch.maximum(got.abs(), want.abs())
            tol = 1e-5
        else:
            got, want, ulp, tol = v_slot, v_slot_p, torch.zeros_like(v_slot), 1e-4
        assert bool(torch.isfinite(got).all())
        for row, row_p, u in zip(got, want, ulp):
            scale = row_p.abs().max().item()
            assert scale > 0
            assert bool(((row - row_p).abs() <= torch.clamp(u, min=tol * scale)).all())


@pytest.mark.gpu
def test_rasterize_gradients_match_the_cpu_on_the_card():
    """The whole backward (K2, unsort, K5, un-permute) on the card against
    the plain versions on the CPU, and bit-equal between two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(1)
    I, N, D, Wd, Hd = 2, 2000, 3, 200, 150
    m2 = torch.rand(I, N, 2, generator=g) * torch.tensor([Wd, Hd])
    a = torch.rand(I, N, generator=g) * 0.5 + 0.02
    c = torch.rand(I, N, generator=g) * 0.5 + 0.02
    b = (torch.rand(I, N, generator=g) - 0.5) * torch.sqrt(a * c)
    inputs = [m2, torch.stack([a, b, c], -1), torch.rand(I, N, D, generator=g),
              torch.rand(I, N, generator=g)]
    dep = torch.rand(I, N, generator=g) + 0.5
    rad = torch.full((I, N, 2), 12, dtype=torch.int32)
    tgt = torch.rand(I, Hd, Wd, D, generator=g)

    def grads(dev):
        xs = [x.to(dev).requires_grad_() for x in inputs]
        m2abs = torch.zeros(I, N, 2, device=dev, requires_grad=True)
        col, alpha, _ = tr.rasterize_to_pixels(*xs, Wd, Hd, rad.to(dev), dep.to(dev), 1 << 18,
                                               absgrad=True, means2d_abs=m2abs)
        (((col - tgt.to(dev)) ** 2).sum() + 0.3 * alpha.sum()).backward()
        return [x.grad.cpu() for x in xs + [m2abs]]

    on_card, again, on_cpu = grads("cuda"), grads("cuda"), grads("cpu")
    for x, y, z in zip(on_card, again, on_cpu):
        assert torch.equal(x, y)
        # sums over pixels and slots in another order: the JAX suite's tolerance
        assert (x - z).abs().max().item() <= 3e-4 * max(1.0, z.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 4, 32])
def test_surfel_kernels_match_plain_versions_on_the_card(D):
    """K8 (with and without its table) and K9 (the record gather and
    align_rows) exact, the record gather equal to the old route (K8's field
    copy, then align_rows through the sort) on padded and unpadded records,
    K6a bit for bit, K6b within 1e-4 of each row's largest entry and with
    K6a's live pairs, on a 2DGS scene on the card (D = 32 stages more than
    48 KB of shared memory in K6b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import gather_kernel as tg
    from gsplat_tpu_torch.ops import rasterize2d_kernel as t2
    from gsplat_tpu_torch.ops.projection2d import fully_fused_projection_2dgs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    C, N, Wd, Hd = 2, 3000, 200, 150
    means = (torch.rand(N, 3, generator=g, device=dev) - 0.5) * torch.tensor([6.0, 4.5, 4.0], device=dev)
    means[:, 2] += 6.0
    quats = torch.randn(N, 4, generator=g, device=dev)
    scales = torch.rand(N, 3, generator=g, device=dev) * 0.15 + 0.02
    vm = torch.eye(4, device=dev).repeat(C, 1, 1)
    vm[1, :3, 3] = torch.tensor([0.2, -0.1, 0.3], device=dev)
    K = torch.tensor([[150.0, 0, Wd / 2], [0, 150.0, Hd / 2], [0, 0, 1]], device=dev).repeat(C, 1, 1)
    radii, m2, depths, M, nrm = fully_fused_projection_2dgs(means, quats, scales, vm, K, Wd, Hd)
    E = C * N
    tw, th = -(-Wd // 16), -(-Hd // 16)
    T = C * tw * th
    cap = 1 << 18
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    table = torch.cat([m2.reshape(E, 2), M.reshape(E, 9), torch.rand(E, 1, generator=g, device=dev),
                       torch.rand(E, D - 1, generator=g, device=dev), depths.reshape(E, 1),
                       nrm.reshape(E, 3)], dim=1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0)
    rect = torch.stack([plan.tminx, plan.tminy, plan.w_rect, plan.im]).contiguous()
    args = (plan.cum_in, rect, depths.reshape(E).contiguous(), table.t().contiguous(),
            plan.n_slots, cap, tw, tw * th, T)
    got, want = tg.expand_emission_aabb(*args), tg.expand_emission_aabb_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    bare = tg.expand_emission_aabb(*args[:3], None, *args[4:])
    assert all(torch.equal(x, y) for x, y in zip(bare[:3], got[:3])) and bare[3] is None
    padded = tr.gaussian_records([table], torch.ones_like(table[:, :1], dtype=torch.bool))
    assert padded.stride(0) % 4 == 0 and torch.equal(padded, table)
    fields_s, bounds, order, flat = tr.expand_sort_align(padded, depths.reshape(E), plan, cap, tw,
                                                         th, C)
    assert torch.equal(flat, got[2])
    old_route = tg.align_rows(got[3], order.to(torch.int32))
    assert torch.equal(fields_s.view(torch.int32), old_route.view(torch.int32))
    for records in (padded, table):  # 16-byte and 4-byte loads
        args9 = (records, flat, order, bounds[T:])
        fields9 = tg.gather_records(*args9)
        assert torch.equal(fields9.view(torch.int32), tg.gather_records_plain(*args9).view(torch.int32))
        assert torch.equal(fields9.view(torch.int32), fields_s.view(torch.int32))
    src = order.to(torch.int32)
    src[::7] = -1  # padding columns read as 0
    emitted = got[3]
    assert torch.equal(tg.align_rows(emitted, src), tg.align_rows_plain(emitted, src))

    kept = torch.empty(T, dtype=torch.int32, device=dev)
    fargs = (fields_s, bounds, C, tw, th, Wd, Hd)
    out, t_fin, med = t2.rasterize2d_fwd(*fargs, pair_counts=kept)
    out_p, t_p, med_p = t2.rasterize2d_fwd_plain(*fargs)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p) and torch.equal(t_fin, t_p) and torch.equal(med, med_p)
    assert int((med >= 0).sum()) > 0

    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    live = torch.empty(T, dtype=torch.int32, device=dev)
    bargs = (*fargs, v_pix, v_t, out, t_fin, med)
    v_slot = t2.rasterize2d_bwd(*bargs, live_counts=live)
    v_slot_p, n_live_p = t2.rasterize2d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
    assert int(live.sum()) == n_live_p > 0
    assert torch.equal(v_slot, t2.rasterize2d_bwd(*bargs)), "two runs differ"
    for row, row_p in zip(v_slot, v_slot_p):
        assert (row - row_p).abs().max().item() <= 1e-4 * row_p.abs().max().item()
    assert (v_slot[:, int(bounds[-1]):] == 0).all()


K3_CASES = ["one_row", "dummies", "row_overflow", "culled_suffix", "empty", "ragged_cap"]


def k3_case(case, dev):
    """K3's inputs (gg_f, gg_i, n_rows, row_cap, tile, n_images) where its
    per-CTA brackets and staging are stressed: 3,000 one-row splats (every
    CTA's 256 rows come from 256 gaussians), a third of the visible
    gaussians off screen (dummies, one record each), a row capacity below
    the rows (row_overflow), a culled suffix, no gaussian at all, and a row
    capacity that is not a multiple of 256."""
    from gsplat_tpu_torch.ops import gather_kernel as tg

    ts, I = 16, 2
    if case == "empty":
        return (torch.zeros((10, 0), device=dev), torch.zeros((6, 0), dtype=torch.int32,
                                                              device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), 1000, ts, I)
    rng = np.random.default_rng(K3_CASES.index(case))
    tw, th = 40, 30
    N = 1500
    if case == "one_row":  # a splat of ~2 px at each tile's centre: one tile row each
        cells = rng.choice(tw * th, (I, N))
        m2 = np.stack([cells % tw, cells // tw], -1) * ts + ts / 2.0
        a = c = np.full((I, N), 2.0)
        b = np.zeros((I, N))
        rad = np.full((I, N, 2), 3)
    else:
        m2 = rng.uniform(0, 1, (I, N, 2)) * [tw * ts, th * ts]
        a = rng.uniform(0.005, 0.5, (I, N))
        c = rng.uniform(0.005, 0.5, (I, N))
        b = (rng.uniform(size=(I, N)) - 0.5) * np.sqrt(a * c)
        rad = rng.integers(1, 60, (I, N, 2))
    if case == "dummies":  # visible, but off screen: no real coverage
        off = rng.uniform(size=(I, N)) < 1 / 3
        m2[off] = -500.0
    if case == "culled_suffix":
        rad[rng.uniform(size=(I, N)) < 0.4] = 0
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    comp = tr.compact_by_depth(t(m2), t(np.stack([a, b, c], -1)), t(np.zeros((I, N, 1))),
                               t(rng.uniform(0.05, 1.0, (I, N))), t(rad, torch.int32),
                               t(rng.uniform(0.5, 2.0, (I, N))))
    geo = tr.row_geometry(comp.means2d, comp.radii, comp.conics, comp.opacities,
                          comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 20)
    total = int(geo.n_rows)
    row_cap = {"row_overflow": total - 3000 - 77, "ragged_cap": total + 1037}.get(
        case, -(-total // 256) * 256)
    n_rows = torch.clamp(geo.n_rows, max=row_cap)
    if case == "culled_suffix":
        assert int(comp.n_live) < I * N
    if case == "dummies":
        assert int((geo.gg_i[tg.GI_IM] == I).sum()) > 500
    return geo.gg_f, geo.gg_i, n_rows, row_cap, ts, I


@pytest.mark.parametrize("case", [c for c in K3_CASES if c != "empty"])
def test_k3_staging_lemma_on_the_plain_plan(case):
    """K3 stages at most 256 gaussians a CTA (csrc/expand.cu's header): on
    the plain plan no 256-row block below n_rows spans more than 256
    gaussians, and the gaussians of the rows never fall."""
    from gsplat_tpu_torch.ops import gather_kernel as tg

    gg_f, gg_i, n_rows, row_cap, ts, I = k3_case(case, torch.device("cpu"))
    x0, ty, im, w, gid = tg.expand_rows_plain(gg_f, gg_i, n_rows, row_cap, ts, I)
    n = int(n_rows)
    assert n > 2000 and (row_cap % 256 != 0) == (case in ("row_overflow", "ragged_cap"))
    live = gid[:n].long()
    assert (live[1:] >= live[:-1]).all() and (w[:n] >= 1).all() and (w[n:] == 0).all()
    blocks = torch.nn.functional.pad(live, (0, -n % 256), value=int(live[-1])).view(-1, 256)
    span = blocks[:, -1] - blocks[:, 0] + 1
    assert int(span.max()) <= 256
    if case == "one_row":  # every gaussian one row: the lemma's bound is met
        assert int(span.max()) == 256


@pytest.mark.gpu
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_brackets_and_staging_on_the_card(case):
    """K3 bit for bit against its plain version on the scenes of k3_case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import gather_kernel as tg

    args = k3_case(case, torch.device("cuda"))
    got, want = tg.expand_rows(*args), tg.expand_rows_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1000, 12289, 1 << 16], ids=["truncated", "ragged", "roomy"])
def test_k8_search_brackets_on_the_card(cap):
    """K8 with and without its table against its plain version where its
    per-CTA search brackets are stressed: a capacity that truncates the
    slots (inside a CTA), one that ends a slot into a CTA, and one with
    room, on culled and one-tile gaussians (one slot each) beside wide
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import gather_kernel as tg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    I, N, tw, th = 2, 700, 13, 9
    m2 = torch.rand(I, N, 2, generator=g, device=dev) * torch.tensor([16.0 * tw, 16.0 * th],
                                                                      device=dev)
    radii = (torch.rand(I, N, 2, generator=g, device=dev) * 40).to(torch.int32)
    radii[:, ::5] = 0  # culled: one dummy slot each
    radii[:, 1::7] = 1  # a tile or two each
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert bool(plan.overflow) == (cap == 1000)
    E, T = I * N, I * tw * th
    rect = torch.stack([plan.tminx, plan.tminy, plan.w_rect, plan.im]).contiguous()
    depth = torch.rand(E, generator=g, device=dev) + 0.5
    table = torch.randn(19, E, generator=g, device=dev)
    for tab in (None, table):
        args = (plan.cum_in, rect, depth, tab, plan.n_slots, cap, tw, tw * th, T)
        got, want = tg.expand_emission_aabb(*args), tg.expand_emission_aabb_plain(*args)
        torch.cuda.synchronize()
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["float32", "packed"])
@pytest.mark.parametrize("case", ["empty", "full", "roomy", "truncated"])
def test_k4_search_brackets_on_the_card(case, packed):
    """K4 in both modes bit for bit against its plain version where its
    per-CTA search brackets are stressed: runs of every width from 1 (many
    of width 1) straddling the 256-slot CTAs, dummy records (one sentinel
    slot each), and n_slots of 0, equal to the capacity, below it and above
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import gather_kernel as tg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    I, tw, th, E, R, F = 2, 13, 9, 900, 5000, 9
    w = torch.randint(1, 41, (R,), generator=g, device=dev)
    w[torch.rand(R, generator=g, device=dev) < 0.4] = 1
    dummy = torch.rand(R, generator=g, device=dev) < 0.1
    w[dummy] = 1
    cum_in = torch.cumsum(w, 0)
    x0 = torch.randint(0, tw, (R,), generator=g, device=dev)
    rr = torch.stack([cum_in - w, cum_in, x0, torch.randint(0, th, (R,), generator=g, device=dev),
                      torch.where(dummy, I, torch.randint(0, I, (R,), generator=g, device=dev)),
                      torch.randint(0, E, (R,), generator=g, device=dev)]).to(torch.int32)
    table = torch.randn(F, E, generator=g, device=dev) * 20.0
    total = int(cum_in[-1])
    n, cap = dict(empty=(0, 4096), full=(total, total), roomy=(total, total + 3001),
                  truncated=(total, total - 777))[case]
    n_slots = torch.tensor([n], dtype=torch.int32, device=dev)
    args = (rr.contiguous(), table, n_slots, cap, tw, tw * th, I * tw * th, packed, 16)
    keys, fields = tg.expand_emission(*args)
    keys_p, fields_p = tg.expand_emission_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys_p)
    assert torch.equal(fields.view(torch.int32), fields_p.view(torch.int32))
    n_live = int((keys < I * tw * th).sum())
    assert n_live == 0 if case == "empty" else 0 < n_live < min(n, cap)  # dummies are sentinels


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 4, 32])
@pytest.mark.parametrize("hit", [False, True], ids=["no_hit", "hit"])
@pytest.mark.parametrize("normals", [False, True], ids=["no_normals", "normals"])
def test_eval3d_kernels_match_plain_versions_on_the_card(D, hit, normals):
    """K7a bit for bit and K7b within 1e-5 of each row's largest entry, with
    K7a's contributing pairs as K7b's live pairs, on rays of a distorted
    pinhole on the card; the hit channel and the normals each on and off,
    so that every field layout is read (D = 2 with the hit channel alone is
    the lidar's; D = 32 with both stages 51 rows: more than 48 KB of shared
    memory in both kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as t3
    from gsplat_tpu_torch.ops.projection_ut import fully_fused_projection_ut
    from gsplat_tpu_torch.ops.rasterize_eval3d import iscl_rot_from_quat_scale
    from gsplat_tpu_torch.sensors import generate_rays, make_camera

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    C, N, Wd, Hd = 2, 3000, 200, 150
    means = (torch.rand(N, 3, generator=g, device=dev) - 0.5) * torch.tensor([6.0, 4.5, 4.0], device=dev)
    means[:, 2] += 6.0
    quats = torch.randn(N, 4, generator=g, device=dev)
    scales = torch.rand(N, 3, generator=g, device=dev) * 0.15 + 0.02
    op = torch.rand(N, generator=g, device=dev)
    vm = torch.eye(4, device=dev).repeat(C, 1, 1)
    vm[1, :3, 3] = torch.tensor([0.2, -0.1, 0.3], device=dev)
    K = torch.tensor([[150.0, 0, Wd / 2], [0, 150.0, Hd / 2], [0, 0, 1]], device=dev).repeat(C, 1, 1)
    rad = torch.tensor([[0.05, -0.01]], device=dev).repeat(C, 1)
    radii, m2, depths, _, _ = fully_fused_projection_ut(means, quats, scales, op, vm, K, Wd, Hd,
                                                        radial_coeffs=rad)
    cam = make_camera("pinhole", Wd, Hd, K[:, [0, 1], [0, 1]], K[:, :2, 2], radial_coeffs=rad)
    rays = generate_rays(cam, Wd, Hd, vm).contiguous()
    rays[0, 70, 90, 3:] = 0.0  # one zero ray: its pixel starts at T = 0
    E = C * N
    tw, th = -(-Wd // 16), -(-Hd // 16)
    cap = 1 << 19
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    cols = torch.rand(E, D, generator=g, device=dev)
    rows = [means.repeat(C, 1), iscl_rot_from_quat_scale(quats, scales).reshape(N, 9).repeat(C, 1),
            op.repeat(C)[:, None]]
    if hit:
        rows.append(scales.repeat(C, 1))
    rows.append(cols)
    if normals:
        rows.append(torch.nn.functional.normalize(torch.randn(E, 3, generator=g, device=dev), dim=1))
    table = torch.where((plan.cnt > 0)[:, None], torch.cat(rows, 1), 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, cap, tw, th, C)
    T = C * tw * th
    geo = (C, tw, th, Wd, Hd, hit, normals)
    kept = torch.empty(T, dtype=torch.int32, device=dev)
    out, t_fin = t3.rasterize_eval3d_fwd(fields, bounds, rays, *geo, pair_counts=kept)
    out_p, t_p = t3.rasterize_eval3d_fwd_plain(fields, bounds, rays, *geo)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p) and torch.equal(t_fin, t_p)
    assert float(t_fin[0, 70, 90]) == 0.0 and int(kept.sum()) > 0

    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    live = torch.empty(T, dtype=torch.int32, device=dev)
    bargs = (fields, bounds, rays, *geo, v_pix, v_t, out, t_fin)
    v_slot, v_rays = t3.rasterize_eval3d_bwd(*bargs, live_counts=live)
    v_slot_p, v_rays_p, n_live_p = t3.rasterize_eval3d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
    assert int(live.sum()) == n_live_p
    again = t3.rasterize_eval3d_bwd(*bargs)
    assert torch.equal(v_slot, again[0]) and torch.equal(v_rays, again[1]), "two runs differ"
    for row, row_p in zip(v_slot, v_slot_p):
        assert (row - row_p).abs().max().item() <= 1e-5 * max(row_p.abs().max().item(), 1e-30)
    for k in range(6):
        got, want = v_rays[..., k], v_rays_p[..., k]
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert (v_slot[:, int(bounds[-1]):] == 0).all()
    if hit:
        assert bool((v_slot[16 + D - 1] == 0).all())  # the input hit channel's row


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["seeded", "opacity_edge", "gate_edge", "reject_edge",
                                  "hit_edge", "scales", "clamp", "rolling", "lidar", "lidar_edge",
                                  "nonfinite"])
def test_eval3d_gate_boundary_on_the_card(case):
    """The early reject and the hoisting of csrc/ray3d.cuh on the boundary
    scenes of tests/test_torch_ray_gate.py (built on the CPU, then moved):
    K7a's counting build, which also runs the exact path on every rejected
    pair, finds none that the exact path keeps; the reject gates some pairs
    in every scene; the tiles of a global shutter take the hoisted route of
    one origin, those of a rolling shutter and a moving lidar the per-pair
    route; K7a equals its plain version bit for bit, and its timed build
    (two slots' responses at once) equals its counting build (one slot at
    a time); K7b's live pairs equal K7a's contributing
    pairs, and each of its finite slots' rows is within 1e-5 of that row's
    largest entry of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as t3
    from test_torch_ray_gate import boundary_scene

    dev = torch.device("cuda")
    fields_cpu, bounds_cpu, rays_cpu, geo = boundary_scene(case)
    fields, bounds, rays = fields_cpu.to(dev), bounds_cpu.to(dev), rays_cpu.to(dev)
    n_tiles = bounds.shape[0] - 1
    kept, n_eval, n_exact, unsound, one = (torch.empty(n_tiles, dtype=torch.int32, device=dev)
                                           for _ in range(5))
    fwd = t3.rasterize_eval3d_fwd(fields, bounds, rays, *geo, pair_counts=kept,
                                  eval_counts=n_eval, exact_counts=n_exact,
                                  unsound_counts=unsound, one_origin=one)
    plain = t3.rasterize_eval3d_fwd_plain(fields, bounds, rays, *geo)
    timed = t3.rasterize_eval3d_fwd(fields, bounds, rays, *geo)
    torch.cuda.synchronize()
    assert int(unsound.sum()) == 0, f"{int(unsound.sum())} rejected pairs the exact path keeps"
    assert 0 < int(n_exact.sum()) < int(n_eval.sum())
    assert all(torch.equal(a, b) for a, b in zip(fwd, plain)), "K7a != its plain version"
    assert all(torch.equal(a, b) for a, b in zip(fwd, timed)), "the timed build differs"
    if case in ("seeded", "gate_edge", "clamp"):
        assert bool((one == 1).all()), "a global shutter's tile took the per-pair route"
    if case in ("rolling", "lidar", "lidar_edge"):
        assert int(one.sum()) == 0, "a moving sensor's tile took the hoisted route"

    out, t_fin = fwd
    g = torch.Generator(device=dev).manual_seed(2)
    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    live = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    bargs = (fields, bounds, rays, *geo, v_pix, v_t, out, t_fin)
    v_slot, v_rays = t3.rasterize_eval3d_bwd(*bargs, live_counts=live)
    v_slot_p, v_rays_p, n_live_p = t3.rasterize_eval3d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
    assert int(live.sum()) == n_live_p > 0
    # a finite slot's rows; the plain version's also multiply the zero terms
    # of gated pairs by a NaN ray's response, the kernel's sum live pairs only
    finite = torch.isfinite(fields[: t3.ROW_OP + 1]).all(0)
    assert bool(torch.isfinite(v_slot[:, finite]).all())
    cols = finite & torch.isfinite(v_slot_p).all(0)
    rows = [r for r in range(v_slot.shape[0]) if r != 16 + 4 - 1]  # the input hit channel's row
    _rows_within(v_slot[rows][:, cols], v_slot_p[rows][:, cols], 1e-5)
    ok = torch.isfinite(rays).all(-1) & torch.isfinite(v_rays_p).all(-1)
    _rows_within(v_rays[ok].t(), v_rays_p[ok].t(), 1e-5)


def _segment_case(case, F, dev, g):
    """(data [F, P], bounds) for one K5 stress case, NaN past bounds[E]."""
    if case == "empty_segments":  # most segments empty, some runs of every length
        E = 50_000
        lens = torch.randint(0, 40, (E,), generator=g, device=dev)
        lens[torch.rand(E, generator=g, device=dev) < 0.7] = 0
        lens[-1000:] = 0  # the last chunks hold only empty segments
    elif case == "long_runs":  # runs of many 16-byte rounds, one of them first
        E = 20_000
        lens = torch.randint(0, 30, (E,), generator=g, device=dev)
        lens[[0, 7_000, 7_001, 19_999]] = torch.tensor([3_843, 1_281, 40_000, 2_562], device=dev)
    elif case == "straddle":  # more CTAs than the card holds at once
        E = 400_000
        lens = torch.randint(0, 41, (E,), generator=g, device=dev)
    else:  # "all_empty": no slot at all
        E = 3_000
        lens = torch.zeros(E, dtype=torch.int64, device=dev)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(lens, 0)])
    n = int(bounds[-1])
    data = torch.full((F, n + 1031), float("nan"), device=dev)  # NaN past bounds[E]
    data[:, :n] = torch.randn(F, n, generator=g, device=dev)
    return data, bounds.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 9, 19, 47])
@pytest.mark.parametrize("case", ["empty_segments", "long_runs", "straddle", "all_empty"])
def test_segment_rowsum_equals_its_plain_version_on_the_card(case, F):
    """K5 bit for bit against its plain version (both add each run serially
    in slot order): empty segments, runs of every alignment and of many
    16-byte rounds, more CTAs than the card holds, NaN past bounds[E], and
    the row counts of the 2DGS step (19), the 3DGS step (9), one and the
    most (47)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import segsum_kernel as tsg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(F)
    data, bounds = _segment_case(case, F, dev, g)
    runs = bounds[1:] - bounds[:-1]
    got = tsg.segment_rowsum(data, bounds)
    want = tsg.segment_rowsum_plain(data, bounds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, tsg.segment_rowsum(data, bounds)), "two runs differ"
    assert bool(torch.isfinite(got).all())
    if case == "long_runs":
        assert int(runs.max()) == 40_000
    if case == "straddle":  # 8 CTAs of 256 threads an SM, per row
        assert runs.shape[0] > 256 * 8 * torch.cuda.get_device_properties(dev).multi_processor_count


def _surfel_inputs(dev, means, quats, scales, op, D, Wd, Hd, g):
    """The sorted slot fields and spans of one camera's surfels, as the 2DGS
    op hands them to K6a and K6b."""
    from gsplat_tpu_torch.ops.projection2d import fully_fused_projection_2dgs

    K = torch.tensor([[[80.0, 0, Wd / 2], [0, 80.0, Hd / 2], [0, 0, 1]]], device=dev)
    vm = torch.eye(4, device=dev)[None]
    radii, m2, depths, M, nrm = fully_fused_projection_2dgs(means, quats, scales, vm, K, Wd, Hd)
    E = means.shape[0]
    tw, th = -(-Wd // 16), -(-Hd // 16)
    cap = 1 << 18
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    table = torch.cat([m2.reshape(E, 2), M.reshape(E, 9), op[:, None],
                       torch.rand(E, D - 1, generator=g, device=dev), depths.reshape(E, 1),
                       nrm.reshape(E, 3)], dim=1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, cap, tw, th, 1)
    return fields, bounds, (1, tw, th, Wd, Hd)


def _surfel_scene(case, dev, g):
    """Surfels in front of one 64 x 64 camera for a K6b stress case."""
    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    if case == "long_spans":  # faint surfels over the centre: spans of several batches
        N = 600
        means = torch.cat([(rand(N, 2) - 0.5) * 1.0, 4.0 + rand(N, 1) * 3.0], 1)
        scales = rand(N, 3) * 0.3 + 0.3
        op = rand(N) * 0.05 + 0.02
    elif case == "all_stop":  # opaque layers in front: every pixel stops early
        N = 400
        means = torch.cat([(rand(N, 2) - 0.5) * 2.0, 3.0 + rand(N, 1) * 5.0], 1)
        scales = rand(N, 3) * 0.4 + 0.2
        front = torch.arange(N, device=dev) < 40
        means[front, :2] = (rand(40, 2) - 0.5) * 1.5
        means[front, 2] = 1.5
        scales[front] = 3.0
        op = torch.where(front, 1.0, rand(N))
    else:  # "branches": edge-on and face-on surfels, a third saturating (the clamp)
        N = 500
        means = torch.cat([(rand(N, 2) - 0.5) * 3.0, 3.0 + rand(N, 1) * 3.0], 1)
        scales = rand(N, 3) * 0.3 + 0.05
        scales[: N // 4, 0] = 1e-3  # thin: the screen filter's branch
        op = torch.where(rand(N) < 0.3, 1.0, rand(N))
    quats = torch.randn(N, 4, generator=g, device=dev)
    return means, quats, scales, op


def _branch_counts(fields, bounds, geo):
    """Live pairs taking the screen filter, the 3D response and the clamp,
    from the plain replay."""
    from gsplat_tpu_torch.ops import rasterize2d_kernel as t2

    n_images, tw, th, Wd, Hd = geo
    counts = torch.zeros(3, dtype=torch.int64)
    for starts, cnt, ids, L in t2._batches(bounds, n_images * tw * th, None, t2.PLAIN_BUDGET):
        sb = t2._surfel_batch(fields, starts, cnt, ids, L, tw, tw * th, Wd, Hd)
        live = sb.live
        counts += torch.stack([(live & sb.use2d).sum(), (live & ~sb.use2d).sum(),
                               (live & ~sb.unclamped).sum()]).cpu()
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_spans", "all_stop", "branches"])
def test_surfel_backward_stress_cases_on_the_card(case):
    """K6b against its plain version on scenes that stress its design: tile
    spans of several staged batches, every pixel stopping early (the CTA
    leaves and writes zeros over the rest of its span), and both the screen
    filter's and the 3D response's branch with the alpha clamp.  Its live
    pairs equal K6a's, each row within 1e-4 of its largest entry, the same
    bits from run to run, zeros outside the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize2d_kernel as t2

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D = 4
    fields, bounds, geo = _surfel_inputs(dev, *_surfel_scene(case, dev, g), D, 64, 64, g)
    spans = bounds[1:] - bounds[:-1]
    n_tiles = spans.shape[0]
    kept = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    n_eval = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    out, t_fin, med = t2.rasterize2d_fwd(fields, bounds, *geo, pair_counts=kept,
                                         eval_counts=n_eval)
    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    bargs = (fields, bounds, *geo, v_pix, v_t, out, t_fin, med)
    live = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    v_slot = t2.rasterize2d_bwd(*bargs, live_counts=live)
    v_slot_p, n_live_p = t2.rasterize2d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
    assert int(live.sum()) == n_live_p > 0
    assert torch.equal(v_slot, t2.rasterize2d_bwd(*bargs)), "two runs differ"
    for row, row_p in zip(v_slot, v_slot_p):
        assert (row - row_p).abs().max().item() <= 1e-4 * row_p.abs().max().item()
    assert (v_slot[:, int(bounds[-1]):] == 0).all()
    if case == "long_spans":
        assert int(spans.max()) > 3 * 64  # more than three of K6b's batches
    elif case == "all_stop":
        # every pixel lies under the opaque layers, and stops there
        assert float(t_fin.max()) < 0.01 and int(n_eval.sum()) < int((spans * 256).sum())
    else:
        n2d, n3d, n_clamped = _branch_counts(fields, bounds, geo).tolist()
        assert n2d > 0 and n3d > 0 and n_clamped > 0, (n2d, n3d, n_clamped)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["seeded", "opacity_edge", "gate_edge", "reject_edge",
                                  "edge_on", "scales", "clamp", "nonfinite_dead"])
def test_surfel_gate_boundary_on_the_card(case):
    """The early reject of csrc/surfel.cuh on the boundary scenes of
    tests/test_torch_surfel_gate.py (built on the CPU, then moved): K6a's
    counting build, which also runs the exact path on every rejected pair,
    finds none that the exact path keeps; K6a equals its plain version bit
    for bit, and its timed build equals its counting build; K6b's live pairs
    equal K6a's contributing pairs, and each of its rows is within 1e-4 of
    that row's largest entry of its plain version.  On a dead slot with a
    NaN or an infinity among its rows, which no live pair reaches, both
    multiply zero sums by those rows: K6b equals the plain version wherever
    that is finite, and its opacity and channel rows are 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize2d_kernel as t2
    from test_torch_surfel_gate import boundary_scene

    dev = torch.device("cuda")
    fields_cpu, bounds_cpu, geo = boundary_scene(case)
    fields, bounds = fields_cpu.to(dev), bounds_cpu.to(dev)
    n_tiles = bounds.shape[0] - 1
    kept, n_eval, n_exact, unsound = (torch.empty(n_tiles, dtype=torch.int32, device=dev)
                                      for _ in range(4))
    fwd = t2.rasterize2d_fwd(fields, bounds, *geo, pair_counts=kept, eval_counts=n_eval,
                             exact_counts=n_exact, unsound_counts=unsound)
    plain = t2.rasterize2d_fwd_plain(fields, bounds, *geo)
    timed = t2.rasterize2d_fwd(fields, bounds, *geo)
    torch.cuda.synchronize()
    assert int(unsound.sum()) == 0, f"{int(unsound.sum())} rejected pairs the exact path keeps"
    assert 0 < int(n_exact.sum()) < int(n_eval.sum())
    assert all(torch.equal(a, b) for a, b in zip(fwd, plain)), "K6a != its plain version"
    assert all(torch.equal(a, b) for a, b in zip(fwd, timed)), "the timed build differs"

    out, t_fin, med = fwd
    g = torch.Generator(device=dev).manual_seed(2)
    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    live = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    bargs = (fields, bounds, *geo, v_pix, v_t, out, t_fin, med)
    v_slot = t2.rasterize2d_bwd(*bargs, live_counts=live)
    v_slot_p, n_live_p = t2.rasterize2d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept), "the backward's live pairs differ from the forward's"
    assert int(live.sum()) == n_live_p > 0
    finite = torch.isfinite(fields[: t2.ROW_COLOR]).all(0)
    dead, dead_p = v_slot[:, ~finite], v_slot_p[:, ~finite]
    assert torch.equal(dead[torch.isfinite(dead_p)], dead_p[torch.isfinite(dead_p)])
    assert (dead[t2.ROW_OP:] == 0).all()
    for row, row_p in zip(v_slot[:, finite], v_slot_p[:, finite]):
        assert (row - row_p).abs().max().item() <= 1e-4 * row_p.abs().max().item()


def _k1_inputs(dev, g, D, ts, packed, N=3000, Wd=200, Hd=150, I=2, radius=12, op_scale=1.0,
               conic=(0.5, 0.02), op_fill=None):
    """Sorted slot rows (float32, or the packed payload) and spans of a
    seeded 3DGS scene with D channels, as rasterize_to_pixels hands them to
    K1 and K2."""
    from gsplat_tpu_torch.ops import gather_kernel as tg

    m2 = torch.rand(I, N, 2, generator=g, device=dev) * torch.tensor([Wd, Hd], device=dev)
    a = torch.rand(I, N, generator=g, device=dev) * conic[0] + conic[1]
    c = torch.rand(I, N, generator=g, device=dev) * conic[0] + conic[1]
    b = (torch.rand(I, N, generator=g, device=dev) - 0.5) * torch.sqrt(a * c)
    cn = torch.stack([a, b, c], -1)
    cl = torch.rand(I, N, D, generator=g, device=dev)
    op = torch.rand(I, N, generator=g, device=dev) * op_scale
    if op_fill is not None:
        op = torch.full_like(op, op_fill)
    dep = torch.rand(I, N, generator=g, device=dev) + 0.5
    rad = torch.full((I, N, 2), radius, dtype=torch.int32, device=dev)
    tw, th = -(-Wd // ts), -(-Hd // ts)
    T = I * tw * th
    comp = tr.compact_by_depth(m2, cn, cl, op, rad, dep)
    plan = tr.make_tight_plan(comp.means2d, comp.radii, comp.conics, comp.opacities,
                              comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 19, 1 << 17)
    assert not bool(plan.overflow)
    table = tr.field_table(comp, plan.dummy)
    keys, fields = tg.expand_emission(plan.rr, table, plan.n_slots, 1 << 19, tw, tw * th, T,
                                      packed=packed, tile_size=ts)
    fs, bounds, _ = tr.sort_slots(keys, fields, T)
    return fs, bounds, (I, ts, tw, th, Wd, Hd)


def _rows_within(got, want, tol):
    for row, row_p in zip(got, want):
        assert bool(torch.isfinite(row).all())
        assert (row - row_p).abs().max().item() <= tol * max(row_p.abs().max().item(), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["k1_k2", "k1_k2_packed", "k6", "k7"])
def test_any_channel_count_matches_plain_versions_on_the_card(path):
    """D = 64 through each composite's wrapper, which launches its kernel on
    groups of at most 32 channels, against the plain version run on all 64
    at once: the forward bit for bit (K1 float32: 1e-4, as above), T and the
    contributing pairs of the first group equal to the backward's live
    pairs; the backward, whose geometry rows add the groups' sums, within
    the row tolerance of each kernel's own test above (K2 packed: 1e-5,
    float32 rows whatever pack_grads asks, with more than one group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize_kernel as tk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    D = 64
    if path.startswith("k1_k2"):
        packed = path.endswith("packed")
        fs, bounds, geo = _k1_inputs(dev, g, D, 16, packed)
        T = bounds.shape[0] - 1
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        modes = dict(packed=packed, n_channels=D)
        launched = tk.rasterize_fwd.launches + tk.rasterize_fwd.launches_packed
        col, t = tk.rasterize_fwd(fs, bounds, *geo, pair_counts=kept, **modes)
        assert tk.rasterize_fwd.launches + tk.rasterize_fwd.launches_packed == launched + 2
        col_p, t_p = tk.rasterize_fwd_plain(fs, bounds, *geo, **modes)
        torch.cuda.synchronize()
        if packed:
            assert torch.equal(col, col_p) and torch.equal(t, t_p)
        else:
            assert (col - col_p).abs().max().item() <= 1e-4
            assert (t - t_p).abs().max().item() <= 1e-4
        v_pix = torch.randn(col.shape, generator=g, device=dev)
        v_t = torch.randn(t.shape, generator=g, device=dev)
        bargs = (fs, bounds, *geo, v_pix, v_t, col, t)
        live = torch.empty(T, dtype=torch.int32, device=dev)
        v_slot = tk.rasterize_bwd(*bargs, live_counts=live, pack_grads=packed, **modes)
        v_slot_p, n_live_p = tk.rasterize_bwd_plain(*bargs, **modes)
        torch.cuda.synchronize()
        assert torch.equal(live, kept) and int(live.sum()) == n_live_p > 0
        assert v_slot.shape == (6 + D, fs.shape[1])
        assert torch.equal(v_slot, tk.rasterize_bwd(*bargs, pack_grads=packed, **modes))
        _rows_within(v_slot, v_slot_p, 1e-5 if packed else 1e-4)
    elif path == "k6":
        from gsplat_tpu_torch.ops import rasterize2d_kernel as t2

        N = 3000
        means = torch.cat([(torch.rand(N, 2, generator=g, device=dev) - 0.5) * 3.0,
                           3.0 + torch.rand(N, 1, generator=g, device=dev) * 4.0], 1)
        quats = torch.randn(N, 4, generator=g, device=dev)
        scales = torch.rand(N, 3, generator=g, device=dev) * 0.15 + 0.02
        op = torch.rand(N, generator=g, device=dev)
        fields, bounds, geo = _surfel_inputs(dev, means, quats, scales, op, D, 200, 150, g)
        T = bounds.shape[0] - 1
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        out, t_fin, med = t2.rasterize2d_fwd(fields, bounds, *geo, pair_counts=kept)
        out_p, t_p, med_p = t2.rasterize2d_fwd_plain(fields, bounds, *geo)
        torch.cuda.synchronize()
        assert torch.equal(out, out_p) and torch.equal(t_fin, t_p) and torch.equal(med, med_p)
        v_pix = torch.randn(out.shape, generator=g, device=dev)
        v_t = torch.randn(t_fin.shape, generator=g, device=dev)
        bargs = (fields, bounds, *geo, v_pix, v_t, out, t_fin, med)
        live = torch.empty(T, dtype=torch.int32, device=dev)
        v_slot = t2.rasterize2d_bwd(*bargs, live_counts=live)
        v_slot_p, n_live_p = t2.rasterize2d_bwd_plain(*bargs)
        torch.cuda.synchronize()
        assert torch.equal(live, kept) and int(live.sum()) == n_live_p > 0
        assert torch.equal(v_slot, t2.rasterize2d_bwd(*bargs))
        _rows_within(v_slot, v_slot_p, 1e-4)
    else:
        from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as t3

        fields, bounds, rays, geo = _eval3d_inputs(dev, g, D, True, True)
        T = bounds.shape[0] - 1
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        out, t_fin = t3.rasterize_eval3d_fwd(fields, bounds, rays, *geo, pair_counts=kept)
        out_p, t_p = t3.rasterize_eval3d_fwd_plain(fields, bounds, rays, *geo)
        torch.cuda.synchronize()
        assert torch.equal(out, out_p) and torch.equal(t_fin, t_p)
        v_pix = torch.randn(out.shape, generator=g, device=dev)
        v_t = torch.randn(t_fin.shape, generator=g, device=dev)
        bargs = (fields, bounds, rays, *geo, v_pix, v_t, out, t_fin)
        live = torch.empty(T, dtype=torch.int32, device=dev)
        v_slot, v_rays = t3.rasterize_eval3d_bwd(*bargs, live_counts=live)
        v_slot_p, v_rays_p, n_live_p = t3.rasterize_eval3d_bwd_plain(*bargs)
        torch.cuda.synchronize()
        assert torch.equal(live, kept) and int(live.sum()) == n_live_p > 0
        again = t3.rasterize_eval3d_bwd(*bargs)
        assert torch.equal(v_slot, again[0]) and torch.equal(v_rays, again[1])
        assert bool((v_slot[16 + D - 1] == 0).all())  # the input hit channel's row
        hit_row = 16 + D - 1
        keep = [f for f in range(v_slot.shape[0]) if f != hit_row]
        _rows_within(v_slot[keep], v_slot_p[keep], 1e-5)
        _rows_within(v_rays.reshape(-1, 6).t(), v_rays_p.reshape(-1, 6).t(), 1e-5)


def _eval3d_inputs(dev, g, D, hit, normals, N=3000, Wd=200, Hd=150, C=2, op_scale=1.0,
                   scale_range=(0.02, 0.15), front=0):
    """Sorted slot rows, spans and rays of a seeded eval3d scene on a
    distorted pinhole, as rasterize_to_pixels_eval3d hands them to K7a and
    K7b; `front` opaque gaussians near the camera stop most pixels early."""
    from gsplat_tpu_torch.ops.projection_ut import fully_fused_projection_ut
    from gsplat_tpu_torch.ops.rasterize_eval3d import iscl_rot_from_quat_scale
    from gsplat_tpu_torch.sensors import generate_rays, make_camera

    means = (torch.rand(N, 3, generator=g, device=dev) - 0.5) * torch.tensor([6.0, 4.5, 4.0], device=dev)
    means[:, 2] += 6.0
    quats = torch.randn(N, 4, generator=g, device=dev)
    scales = torch.rand(N, 3, generator=g, device=dev) * (scale_range[1] - scale_range[0]) + scale_range[0]
    op = torch.rand(N, generator=g, device=dev) * op_scale
    if front:
        means[:front, 2] = 2.0
        scales[:front] = 0.6
        op[:front] = 0.98
    vm = torch.eye(4, device=dev).repeat(C, 1, 1)
    vm[1:, :3, 3] = torch.tensor([0.2, -0.1, 0.3], device=dev)
    K = torch.tensor([[150.0, 0, Wd / 2], [0, 150.0, Hd / 2], [0, 0, 1]], device=dev).repeat(C, 1, 1)
    rad = torch.tensor([[0.05, -0.01]], device=dev).repeat(C, 1)
    radii, m2, depths, _, _ = fully_fused_projection_ut(means, quats, scales, op, vm, K, Wd, Hd,
                                                        radial_coeffs=rad)
    cam = make_camera("pinhole", Wd, Hd, K[:, [0, 1], [0, 1]], K[:, :2, 2], radial_coeffs=rad)
    rays = generate_rays(cam, Wd, Hd, vm).contiguous()
    E = C * N
    tw, th = -(-Wd // 16), -(-Hd // 16)
    cap = 1 << 20
    plan = tr.make_emission_plan(m2, radii, 16, tw, th, cap)
    assert not bool(plan.overflow) and int(plan.n_isects) > 0
    rows = [means.repeat(C, 1), iscl_rot_from_quat_scale(quats, scales).reshape(N, 9).repeat(C, 1),
            op.repeat(C)[:, None]]
    if hit:
        rows.append(scales.repeat(C, 1))
    rows.append(torch.rand(E, D, generator=g, device=dev))
    if normals:
        rows.append(torch.nn.functional.normalize(torch.randn(E, 3, generator=g, device=dev), dim=1))
    table = torch.where((plan.cnt > 0)[:, None], torch.cat(rows, 1), 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, depths.reshape(E), plan, cap, tw, th, C)
    return fields, bounds, rays, (C, tw, th, Wd, Hd, hit, normals)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_spans", "all_stop", "lead_and_tail"])
@pytest.mark.parametrize("hit_normals", [False, True], ids=["plain_rows", "hit_normals"])
@pytest.mark.parametrize("size", [(200, 150), (37, 21)], ids=["200x150", "37x21"])
def test_k7b_stress_cases_on_the_card(case, hit_normals, size):
    """K7b where its batches, early exit and zero writes are stressed: spans
    of many 64-slot batches, pixels that all stop within the first batches
    (the CTA leaves and zeroes the rest of its span), and slots outside every
    span before the first tile's and after the last (each CTA zeroes its
    share); at 200x150 and 37x21, whose edge tiles cut through the 8x4
    blocks that share a thread (kPix's edges) and leave whole blocks outside
    the image; with the hit channel and the normals off and on.  The outputs
    are allocated uncleared over NaN-filled memory, so an element no CTA
    writes shows.  Live pairs equal K7a's, two runs give the same bits, the
    input hit channel's row is 0, the rows and the ray gradients are within
    1e-5 of their largest entries of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as t3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    D = 4 if hit_normals else 3
    Wd, Hd = size
    kw = dict(long_spans=dict(N=6000, op_scale=0.15, scale_range=(0.2, 0.5)),
              all_stop=dict(N=3000, front=200), lead_and_tail=dict(N=2000))[case]
    fields, bounds, rays, geo = _eval3d_inputs(dev, g, D, hit_normals, hit_normals, Wd=Wd, Hd=Hd,
                                               C=1, **kw)
    lead = 37 if case == "lead_and_tail" else 0
    if lead:  # slots before the first span: junk rows that no tile reads
        fields = torch.cat([torch.full((fields.shape[0], lead), float("nan"), device=dev), fields], 1)
        bounds = bounds + lead
    spans = bounds[1:] - bounds[:-1]
    if case == "long_spans":
        assert int(spans.max()) > 6 * 64
    T = bounds.shape[0] - 1
    kept = torch.empty(T, dtype=torch.int32, device=dev)
    n_eval = torch.empty(T, dtype=torch.int32, device=dev)
    out, t_fin = t3.rasterize_eval3d_fwd(fields, bounds, rays, *geo, pair_counts=kept,
                                         eval_counts=n_eval)
    v_pix = torch.randn(out.shape, generator=g, device=dev)
    v_t = torch.randn(t_fin.shape, generator=g, device=dev)
    bargs = (fields, bounds, rays, *geo, v_pix, v_t, out, t_fin)
    live = torch.empty(T, dtype=torch.int32, device=dev)
    torch.empty(1 << 28, device=dev).fill_(float("nan"))  # the allocator's next blocks
    v_slot, v_rays = t3.rasterize_eval3d_bwd(*bargs, live_counts=live)
    again = t3.rasterize_eval3d_bwd(*bargs)
    v_slot_p, v_rays_p, n_live_p = t3.rasterize_eval3d_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(live, kept) and int(live.sum()) == n_live_p > 0
    assert torch.equal(v_slot.view(torch.int32), again[0].view(torch.int32)), "two runs differ"
    assert torch.equal(v_rays.view(torch.int32), again[1].view(torch.int32)), "two runs differ"
    n_sorted = int(bounds[-1])
    outside = torch.cat([v_slot[:, :lead], v_slot[:, n_sorted:]], 1)
    assert (outside.view(torch.int32) == 0).all(), "a slot outside every span is not zero"
    if case == "all_stop":
        assert float(t_fin.max()) < 0.02  # every pixel stopped
    keep = list(range(v_slot.shape[0]))
    if hit_normals:
        hit_row = 16 + D - 1
        assert (v_slot[hit_row].view(torch.int32) == 0).all()  # the input hit channel's row
        keep.remove(hit_row)
    assert bool(torch.isfinite(v_rays).all())
    _rows_within(v_slot[keep], v_slot_p[keep], 1e-5)
    _rows_within(v_rays.reshape(-1, 6).t(), v_rays_p.reshape(-1, 6).t(), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_spans", "all_stop", "edge"])
@pytest.mark.parametrize("packed", [False, True], ids=["float32", "packed"])
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_k1_stress_cases_on_the_card(case, packed, ts):
    """K1 against its plain version where its batches, early exits and
    coalesced stores are stressed: spans of many 64-slot batches, pixels
    that all stop within the first batches, and a 37x21 image whose edge
    tiles cut through the 8x4 blocks (whole blocks outside, rows of fewer
    than 8 pixels).  The outputs are allocated over NaN-filled memory, so a
    pixel no CTA writes shows.  Packed bit for bit, float32 within 1e-4 (as
    above); the contributing pairs equal K2's live pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import rasterize_kernel as tk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    D = 3
    kw = dict(long_spans=dict(N=6000, radius=40, op_scale=0.2, conic=(0.05, 0.005)),
              all_stop=dict(N=3000, radius=40, conic=(0.05, 0.005), op_fill=0.98),
              edge=dict(N=400, Wd=37, Hd=21, radius=8))[case]
    fs, bounds, geo = _k1_inputs(dev, g, D, ts, packed, I=1, **kw)
    spans = bounds[1:] - bounds[:-1]
    if case == "long_spans":
        assert int(spans.max()) > 4 * 64
    T = bounds.shape[0] - 1
    modes = dict(packed=packed, n_channels=D)
    kept = torch.empty(T, dtype=torch.int32, device=dev)
    torch.empty(1 << 28, device=dev).fill_(float("nan"))  # the allocator's next blocks
    col, t = tk.rasterize_fwd(fs, bounds, *geo, pair_counts=kept, **modes)
    col_p, t_p = tk.rasterize_fwd_plain(fs, bounds, *geo, **modes)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(col).all()) and bool(torch.isfinite(t).all())
    if packed:
        assert torch.equal(col, col_p) and torch.equal(t, t_p)
    else:
        assert (col - col_p).abs().max().item() <= 1e-4
        assert (t - t_p).abs().max().item() <= 1e-4
    v_pix = torch.randn(col.shape, generator=g, device=dev)
    v_t = torch.randn(t.shape, generator=g, device=dev)
    live = torch.empty(T, dtype=torch.int32, device=dev)
    tk.rasterize_bwd(fs, bounds, *geo, v_pix, v_t, col, t, live_counts=live, **modes)
    torch.cuda.synchronize()
    assert torch.equal(live, kept) and int(kept.sum()) > 0
    if case == "all_stop":
        assert float(t.max()) < 0.02  # every pixel stopped


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
@pytest.mark.parametrize("C", [1, 2])
def test_projection_kernel_matches_its_plain_version_on_the_card(dtype, deg, antialiased, C):
    """The one-pass projection (csrc/projection_fwd.cu) against its plain
    version on the card, on tests/test_torch_projection_kernel.py's seeded
    scene with its degenerate rows: radii, means2d, depths, conics and
    opacities bit for bit (the kernel follows PyTorch's order on the card,
    the quaternion's squared norm as torch.sum adds a row of 4, (w^2 + y^2)
    + (x^2 + z^2)); the colours within 1e-5, since the SH sums carry no gate
    (the kernel follows PyTorch's order there too: torch.linalg.vector_norm's
    (x^2 + z^2) + y^2, the basis sum's four partial sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import projection_kernel as pk
    from test_torch_projection_kernel import project_args, projection_scene, same_bits

    s = projection_scene(N=20000, C=C, dtype=dtype, device="cuda")
    args, kw = project_args(s, deg, antialiased)
    launches = pk.project_shade.launches
    got = pk.project_shade(*args, **kw)
    want = pk.project_shade_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pk.project_shade.launches == launches + 1
    for name, x, y in zip(("radii", "means2d", "depths", "conics", "op"), got, want):
        bad = ~(x.view(torch.int32) == y.view(torch.int32)) & ~(x.isnan() & y.isnan()) \
            if x.dtype == torch.float32 else x != y
        assert same_bits(x, y), (name, int(bad.sum()), bad.nonzero()[:4].tolist(),
                                 x[bad][:4].tolist(), y[bad][:4].tolist())
    assert (got[5] - want[5]).abs().max().item() <= 1e-5
    assert bool((got[0] > 0).all(-1).any())


@pytest.mark.gpu
def test_projection_kernel_radii_at_the_serving_shape():
    """The serving cell's scene (2,794,625 gaussians, SH 3, bf16 fields) at
    3840x2160 from three of its poses: the kernel's radii, means2d, depths,
    conics and opacities equal the plain version's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from benchmark.harness import scene as bench_scene
    from benchmark.harness import traffic
    from gsplat_tpu_torch.ops import projection_kernel as pk
    from gsplat_tpu_torch.scene import GaussianInferenceScene, GaussianScene
    from test_torch_projection_kernel import same_bits

    cfg = json.loads((ROOT / "benchmark" / "configs" / "grid5-3dgs.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic" / "serve-4k.json").read_text())
    params = bench_scene.make_scene(cfg, 2147483647 + 12345, "cuda")
    cams = traffic.cameras(mix, params["means"])
    sc = GaussianInferenceScene.from_gaussian_scene(GaussianScene("grid", params), id="grid")
    del params
    fields = [sc.get(k) for k in ("means", "quats", "scales", "opacities", "colors")]
    for pose in (0, 13, 26):
        args = (*fields, cams.viewmats[pose:pose + 1], cams.K[None], mix["width"], mix["height"])
        kw = dict(sh_degree=3, near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
                  radius_clip=cfg["radius_clip"])
        got = pk.project_shade(*args, **kw)
        want = pk.project_shade_plain(*args, **kw)
        torch.cuda.synchronize()
        for name, x, y in zip(("radii", "means2d", "depths", "conics", "op"), got, want):
            assert same_bits(x, y), (pose, name)
        assert bool((got[0] > 0).all(-1).any())
        assert (got[5] - want[5]).abs().max().item() <= 1e-5
        del got, want


@pytest.mark.parametrize("kernel, source", [("project_shade", "projection_fwd.cu"),
                                            ("project_shade_bwd", "projection_bwd.cu")])
def test_projection_kernels_have_plain_versions_counters_and_source_notes(kernel, source):
    """Each projection kernel's wrapper has its plain version beside it and
    counts its launches; its source opens with what it replaces, what bounds
    it on the card and its design."""
    from gsplat_tpu_torch.ops import projection_kernel as pk

    assert callable(getattr(pk, f"{kernel}_plain"))
    assert isinstance(getattr(pk, kernel).launches, int)
    note = (ROOT / "gsplat_tpu_torch" / "csrc" / source).read_text().split("#include")[0]
    for part in ("Replaces no Pallas kernel", "What bounds it on the H100", "Design."):
        assert part in note, part


# The gradients of the training route's kernels against autograd through the
# plain route on the card, as a share of each leaf's largest entry: float32
# both, summed in other orders.  On the CPU (the backward's arithmetic
# compiled for the host) both sit as far from a float64 autograd, up to
# 4.6e-5 classic and 6.5e-4 antialiased, where the compensation divides two
# determinants that nearly cancel; kernel against autograd, 3e-5 and 1.7e-4.
GRAD_RTOL = {False: 5e-4, True: 3e-3}


def _grad_gaps(got, want):
    return [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
@pytest.mark.parametrize("C", [1, 2])
def test_projection_grad_kernels_match_autograd_on_the_card(deg, antialiased, C):
    """The training route (ops/projection_kernel.py:project_shade_grad) on
    the card, on tests/test_torch_projection_grad.py's seeded case with its
    degenerate rows: the forward kernel's radii, means2d, depths, conics and
    opacities equal the plain version's bit for bit, its colours within
    1e-5; the backward kernel's gradient of each leaf is within GRAD_RTOL of
    the leaf's largest entry of autograd's through the plain route
    (project_shade_bwd_plain), and zero where autograd's is: sanitised rows,
    coefficient rows past (deg + 1)^2.  One launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsplat_tpu_torch.ops import projection_kernel as pk
    from test_torch_projection_grad import LEAVES, SANITISED, grad_case
    from test_torch_projection_kernel import project_args, same_bits

    s, cots = grad_case(20000, C, deg, device="cuda")
    args, kw = project_args(s, deg, antialiased)
    leaves = [s[k].clone().requires_grad_(True) for k in LEAVES]
    launches = pk.project_shade.launches, pk.project_shade_bwd.launches
    out = pk.project_shade_grad(*leaves, *args[5:], **kw)
    grads = torch.autograd.grad(out[1:], leaves, cots)
    torch.cuda.synchronize()
    assert (pk.project_shade.launches, pk.project_shade_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = pk.project_shade_plain(*args, **kw)
    for name, x, y in zip(("radii", "means2d", "depths", "conics", "op"), out, want):
        assert same_bits(x, y), name
    assert (out[5] - want[5]).abs().max().item() <= 1e-5
    want_grads = pk.project_shade_bwd_plain(*args[:7], out[0], *cots, *args[7:], **kw)
    gaps = _grad_gaps(grads, want_grads)
    print(f"deg {deg} {'antialiased' if antialiased else 'classic'} C {C}: "
          + ", ".join(f"{k} {g:.2e}" for k, g in zip(LEAVES, gaps)))
    assert all(g <= GRAD_RTOL[antialiased] for g in gaps), dict(zip(LEAVES, gaps))
    for name, g in zip(LEAVES, grads):
        assert not bool(g[SANITISED].any()), name
    assert not bool(grads[4][:, (deg + 1) ** 2:].any())
    assert bool((out[0] > 0).all(-1).any())


@pytest.mark.gpu
def test_projection_grad_kernels_at_the_training_shape():
    """The training cell's scene (2,794,625 gaussians, SH 3) as the trainer
    passes it (float32 activations of its parameters) to two of its
    3840x2160 views, with seven rows made degenerate (a NaN and an infinite
    mean, a zero and a NaN quaternion, a NaN scale and opacity) and one on
    the first camera's plane: the forward bit for bit and the gradients of
    random cotangents within GRAD_RTOL["classic"] of autograd's through the
    plain route, zero on the degenerate rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from benchmark.harness import scene as bench_scene
    from benchmark.harness import traffic
    from gsplat_tpu_torch.ops import projection_kernel as pk
    from test_torch_projection_kernel import same_bits

    cfg = json.loads((ROOT / "benchmark" / "configs" / "grid5-3dgs.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic" / "train-4k.json").read_text())
    raw = bench_scene.make_scene(cfg, 2147483647 + 23, "cuda")
    cams = traffic.cameras(mix, raw["means"])
    N = raw["means"].shape[0]
    fields = dict(means=raw["means"].clone(), quats=raw["quats"].clone(),
                  scales=torch.exp(raw["scales"]), opacities=torch.sigmoid(raw["opacities"]),
                  coeffs=torch.cat([raw["sh0"], raw["shN"]], dim=1))
    del raw
    nan = float("nan")
    fields["means"][0, 0] = nan
    fields["means"][1, 2] = float("inf")
    fields["quats"][2] = 0.0
    fields["quats"][3, 1] = nan
    fields["scales"][4, 0] = nan
    fields["opacities"][5] = nan
    fields["opacities"][6] = nan
    vm = cams.viewmats[[0, 7]]
    # row 7 on the first camera's plane: its camera-frame depth is 0
    R, t = vm[0, :3, :3], vm[0, :3, 3]
    fields["means"][7] = R.T @ (torch.tensor([0.5, 0.2, 0.0], device="cuda") - t)
    Ks = cams.K[None].expand(2, 3, 3).contiguous()
    kw = dict(sh_degree=3, near_plane=cfg["near_plane"], far_plane=cfg["far_plane"],
              radius_clip=cfg["train_radius_clip"])
    names = ("means", "quats", "scales", "opacities", "coeffs")
    leaves = [fields[k].clone().requires_grad_(True) for k in names]
    out = pk.project_shade_grad(*leaves, vm, Ks, mix["width"], mix["height"], **kw)
    g = torch.Generator(device="cuda").manual_seed(7)
    cots = [torch.randn(o.shape, generator=g, device="cuda") for o in out[1:]]
    cots[2] *= 1e-3
    grads = torch.autograd.grad(out[1:], leaves, cots)
    args = (*(fields[k] for k in names), vm, Ks, mix["width"], mix["height"])
    want = pk.project_shade_plain(*args, **kw)
    for name, x, y in zip(("radii", "means2d", "depths", "conics", "op"), out, want):
        assert same_bits(x, y), name
    assert (out[5] - want[5]).abs().max().item() <= 1e-5
    del want
    want_grads = pk.project_shade_bwd_plain(*args[:7], out[0], *cots, *args[7:], **kw)
    gaps = _grad_gaps(grads, want_grads)
    print("training shape: " + ", ".join(f"{k} {v:.2e}" for k, v in zip(names, gaps)))
    assert all(v <= GRAD_RTOL[False] for v in gaps), dict(zip(names, gaps))
    for name, x in zip(names, grads):
        assert not bool(x[:7].any()), name
    visible = (out[0] > 0).all(-1)
    assert 0 < int(visible.sum()) < 2 * N and not bool(visible[:, :7].any())
