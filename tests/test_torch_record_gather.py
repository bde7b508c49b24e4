"""The gather into sorted order (K9, `gather_records`) and the emission
without its field table (K8, `expand_emission_aabb(table=None)`), on the
CPU through their plain versions.

`expand_sort_align` reads each sorted slot's fields from the callers'
gaussian-major records through the sort.  The route it replaces copied the
fields into an emission-ordered [R, cap] table (K8's full mode) and
gathered its columns through the sort's permutation (`align_rows`).  Both
are copies, so the two routes must agree bit for bit: the sorted fields,
the spans and the permutation, on the tables that the 2DGS op and the
eval3d op really hand over (captured from a forward through each op), and
K8's keys, depths and ids must not depend on the table.  The JAX pins of
K8's full mode and of `align_rows` stay in tests/test_torch_emission2d.py.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import rasterization, rasterization_2dgs
from gsplat_tpu_torch.ops import gather_kernel as tg
from gsplat_tpu_torch.ops import rasterize as tr
from gsplat_tpu_torch.ops import rasterize2d as t2d
from gsplat_tpu_torch.ops import rasterize_eval3d as t3d

W, H = 64, 48


def _scene(seed, N=300):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)), rng.uniform(3.0, 7.0, (N, 1))], 1)
    quats = rng.standard_normal((N, 4))
    scales = rng.uniform(0.03, 0.3, (N, 3))
    opacities = rng.uniform(0.05, 0.95, N)
    colors = rng.uniform(0.0, 1.0, (N, 3))
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    vm = torch.eye(4)[None].repeat(2, 1, 1)
    vm[1, :3, 3] = torch.tensor([0.3, -0.2, 0.4])
    K = torch.tensor([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]])[None].repeat(2, 1, 1)
    return f(means), f(quats), f(scales), f(opacities), f(colors), vm, K


def _captured(path, monkeypatch):
    """The arguments and results of expand_sort_align in one forward of the
    op on a two-camera scene."""
    seen = []
    module = t2d if path == "2dgs" else t3d

    def spy(*args):
        out = tr.expand_sort_align(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(module, "expand_sort_align", spy)
    means, quats, scales, op, colors, vm, K = _scene(3)
    if path == "2dgs":
        rasterization_2dgs(means, quats, scales, op, colors, vm, K, W, H)
    else:
        rasterization(means, quats, scales, op, colors, vm, K, W, H, with_ut=True,
                      with_eval3d=True, render_mode="RGB-Ed" if path == "eval3d_hit" else "RGB",
                      return_normals=path == "eval3d_hit")
    assert len(seen) == 1
    return seen[0]


def _old_route(records, depth, plan, cap, tw, th, n_images):
    """The field-major route: K8 with its table, the stable sort, the spans,
    align_rows through the permutation."""
    T = n_images * tw * th
    rect = torch.stack([plan.tminx, plan.tminy, plan.w_rect, plan.im]).contiguous()
    keys, depth_s, flat, fields = tg.expand_emission_aabb(
        plan.cum_in, rect, depth.contiguous(), records.t().contiguous(), plan.n_slots, cap, tw,
        tw * th, T)
    bits = depth_s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keys_s, order = torch.sort((keys.to(torch.int64) << 32) | bits, stable=True)
    fields_s = tg.align_rows(fields, order.to(torch.int32))
    probes = torch.arange(T + 1, dtype=torch.int64) << 32
    bounds = torch.searchsorted(keys_s, probes, side="left", out_int32=True)
    return fields_s, bounds, order, flat


@pytest.mark.parametrize("path", ["2dgs", "eval3d", "eval3d_hit"])
def test_record_gather_equals_the_field_major_route(path, monkeypatch):
    args, (fields_s, bounds, order, flat) = _captured(path, monkeypatch)
    records = args[0]
    R = {"2dgs": 19, "eval3d": 16, "eval3d_hit": 23}[path]
    assert records.shape[1] == R and records.stride(0) % 4 == 0  # padded rows
    want = _old_route(*args)
    assert torch.equal(fields_s.view(torch.int32), want[0].view(torch.int32))
    for got, w in zip((bounds, order, flat), want[1:]):
        assert torch.equal(got, w)
    T = bounds.shape[0] - 1
    n_live = int(bounds[T])
    assert 0 < n_live < fields_s.shape[1]
    assert bool((fields_s[:, n_live:] == 0).all())  # the sentinel tail
    assert bool((fields_s[:, :n_live] != 0).any(dim=1).all())


@pytest.mark.parametrize("path", ["2dgs", "eval3d_hit"])
def test_k8_without_a_table_gives_the_full_modes_keys_depth_and_ids(path, monkeypatch):
    (records, depth, plan, cap, tw, th, n_images), _ = _captured(path, monkeypatch)
    T = n_images * tw * th
    rect = torch.stack([plan.tminx, plan.tminy, plan.w_rect, plan.im]).contiguous()
    args = (plan.cum_in, rect, depth.contiguous())
    rest = (plan.n_slots, cap, tw, tw * th, T)
    full = tg.expand_emission_aabb(*args, records.t().contiguous(), *rest)
    bare = tg.expand_emission_aabb(*args, None, *rest)
    assert bare[3] is None and full[3].shape == (records.shape[1], cap)
    for a, b in zip(bare[:3], full[:3]):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int((bare[0] < T).sum()) == int(plan.n_isects) > 0


@pytest.mark.parametrize("R", [4, 19, 23])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_gather_records_plain_is_the_gather_through_the_sort(R, padded):
    """Against a loop over positions, on records that hold -0.0, NaN and
    infinities (copied, bit for bit), with the sentinel tail at 0, inside
    and at the end of the positions."""
    rng = np.random.default_rng(R)
    E, cap = 50, 120
    vals = rng.standard_normal((E, R)).astype(np.float32)
    vals[3, 0], vals[4, 1 % R], vals[5, 2 % R] = -0.0, np.nan, np.inf
    stride = -(-R // 4) * 4 if padded else R
    store = torch.zeros((E, stride))
    store[:, :R] = torch.from_numpy(vals)
    records = store[:, :R]
    flat = torch.from_numpy(rng.integers(0, E, cap).astype(np.int32))
    order = torch.from_numpy(rng.permutation(cap).astype(np.int64))
    for n in (0, 37, cap):
        got = tg.gather_records(records, flat, order, torch.tensor([n], dtype=torch.int32))
        want = np.zeros((R, cap), np.float32)
        for a in range(n):
            want[:, a] = vals[flat[order[a]]]
        assert got.shape == (R, cap)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_gather_records_refuses_what_the_kernel_does_not_take():
    records = torch.zeros((5, 4))
    flat = torch.zeros(8, dtype=torch.int32)
    order = torch.arange(8)
    n = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="records"):
        tg.gather_records(records.t(), flat, order, n)
    with pytest.raises(ValueError, match="order"):
        tg.gather_records(records, flat, order.to(torch.int32), n)
    with pytest.raises(ValueError, match="flat"):
        tg.gather_records(records, flat.long(), order, n)
    with pytest.raises(ValueError, match="n_live"):
        tg.gather_records(records, flat, order, n.long())


@pytest.mark.parametrize("widths", [(2, 9, 1, 4, 3), (3, 9, 1, 3), (3, 9, 1, 3, 3, 3)])
def test_gaussian_records_pad_each_row_to_16_bytes(widths):
    g = torch.Generator().manual_seed(1)
    E = 7
    cols = [torch.randn(E, w, generator=g) for w in widths]
    keep = (torch.arange(E) % 3 != 0)[:, None]
    R = sum(widths)
    fill = torch.arange(R, dtype=torch.float32)[None]
    for f in (None, fill):
        got = tr.gaussian_records(cols, keep, f)
        want = torch.where(keep, torch.cat(cols, 1), 0.0 if f is None else f)
        assert got.shape == (E, R) and got.stride() == (-(-R // 4) * 4, 1)
        assert torch.equal(got, want)
