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
PORT_FILES = sorted((ROOT / "gsplat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        dict(with_ut=True), dict(with_eval3d=True), dict(camera_model="lidar"),
        dict(fast=True), dict(absgrad=True), dict(means2d_offset=torch.zeros(1, 10, 2)),
        dict(pack_payload=True), dict(pack_grads=True),
    ],
    ids=lambda o: next(iter(o)),
)
def test_out_of_slice_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        _small_call(**option)


def test_in_slice_call_and_backward_raises():
    c, a, meta = _small_call()
    assert c.shape == (1, 32, 32, 3) and float(a.max()) > 0
    assert not bool(meta["isect_overflow"])
    # the forward sits in an autograd Function whose backward is the next slice's
    colors = torch.rand(1, 10, 3, requires_grad=True)
    m2 = torch.full((1, 10, 2), 16.0)
    cn = torch.tensor([0.1, 0.0, 0.1]).repeat(1, 10, 1)
    out, _, _ = tr.rasterize_to_pixels(
        m2, cn, colors, torch.full((1, 10), 0.5), 32, 32,
        torch.full((1, 10, 2), 5, dtype=torch.int32), torch.ones(1, 10), 512,
    )
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_render_scene_fast_raises_and_depth_modes_take_the_exact_path():
    sp = _splats()
    scene = splats_from_numpy(sp, device="cpu")
    inf = GaussianInferenceScene.from_gaussian_scene(scene, id="s")
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 4.0
    K = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]], np.float32)
    with pytest.raises(NotImplementedError, match="item 6"):
        render_scene(inf, viewmat=vm, K=K, width=32, height=32)
    c, a, meta = render_scene(inf, viewmat=vm, K=K, width=32, height=32, render_mode="D")
    assert c.shape == (1, 32, 32, 1) and meta["render_path"] == "inference"


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
                                  comp.image_ids, comp.n_live, I, ts, tw, th, 1 << 18, 1 << 17)
        assert not bool(plan.overflow)
        table = tr.field_table(comp, plan.dummy)
        args = (plan.rr, table, plan.n_slots, 1 << 18, tw, tw * th, T)
        keys, fields = tg.expand_emission(*args)
        keys_p, fields_p = tg.expand_emission_plain(*args)
        assert torch.equal(keys, keys_p) and torch.equal(fields, fields_p)
        fs, bounds = tr.sort_slots(keys, fields, T)
        col, t = tk.rasterize_fwd(fs, bounds, I, ts, tw, th, Wd, Hd)
        col_p, t_p = tk.rasterize_fwd_plain(fs, bounds, I, ts, tw, th, Wd, Hd)
        torch.cuda.synchronize()
        # exp ulps and the order of the colour sums differ: 1e-4 absolute
        assert (col - col_p).abs().max().item() <= 1e-4
        assert (t - t_p).abs().max().item() <= 1e-4
