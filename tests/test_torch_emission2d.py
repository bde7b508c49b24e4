"""Port parity: the AABB emission machinery of the 2DGS path against
gsplat_tpu (ops/rasterize.py:1037-1215, gather_pallas.py K8 and K9 in
interpret mode).

Integers and gathered floats are compared exactly.  The JAX emission kernel
gives a culled gaussian's dummy slot its (zeroed) depth and flat id; the
port gives every dead slot depth inf and id 0 by select, so those two rows
are compared on live slots and checked against the port's rule elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu.ops.rasterize as jr
from gsplat_tpu.ops.isect import isect_tiles
from gsplat_tpu.ops.projection2d import fully_fused_projection_2dgs as jproj
from gsplat_tpu_torch.ops import gather_kernel as tg
from gsplat_tpu_torch.ops import rasterize as tr

from test_torch_projection2d import ARGS, H, W, surfel_scene

TS = 16
TW, TH = -(-W // TS), -(-H // TS)


def _projected(seed=5):
    s = surfel_scene(seed=seed)
    radii, m2, d, M, nrm = (np.array(x) for x in jproj(*(jnp.asarray(s[k]) for k in ARGS), W, H))
    return s, radii, m2, d, M, nrm


PLAN_FIELDS = ("cnt", "cum_ex", "cum_in", "tminx", "tminy", "w_rect", "im")


@pytest.mark.parametrize("cap_total", [4096, 512])
def test_emission_plan_matches_jax(cap_total):
    """Integers exact, with a capacity that holds every slot and one that
    truncates (512 of the scene's ~1200 slots)."""
    _, radii, m2, *_ = _projected()
    want = jr.make_emission_plan(jnp.asarray(m2), jnp.asarray(radii), TS, TW, TH, cap_total)
    got = tr.make_emission_plan(torch.from_numpy(m2), torch.from_numpy(radii), TS, TW, TH,
                                cap_total)
    for k in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    assert int(got.n_slots[0]) == int(want.n_slots)
    assert int(got.n_isects) == int(want.n_isects)
    assert bool(got.overflow) == bool(want.overflow) == (cap_total == 512)
    # a culled gaussian emits one dummy slot that counts against the
    # capacity and not in n_isects
    n_dummy = int((got.cnt == 0).sum())
    assert n_dummy > 0
    assert int(got.cum_in[-1]) == int(got.n_isects) + n_dummy
    assert int(got.n_slots[0]) == min(int(got.cum_in[-1]), cap_total)


@pytest.fixture(scope="module")
def jax_pipeline():
    """JAX's expand_sort_align on the scene, with the arguments and results
    of its emission (K8) and alignment (K9) kernels captured."""
    s, radii, m2, d, M, nrm = _projected()
    C, N = radii.shape[:2]
    E = C * N
    cap_total = jr._round_up(4096 + E, 512)
    plan = jr.make_emission_plan(jnp.asarray(m2), jnp.asarray(radii), TS, TW, TH, cap_total)
    ok = np.asarray(plan.cnt) > 0
    colors = np.broadcast_to(s["colors"][None], (C, N, 3)).reshape(E, 3)
    table = np.concatenate([m2.reshape(E, 2), M.reshape(E, 9), np.tile(s["opacities"], C)[:, None],
                            colors, d.reshape(E, 1), nrm.reshape(E, 3)], axis=1)
    table = np.where(ok[:, None], table, 0.0).astype(np.float32).T.copy()  # [19, E]
    depthf = np.where(ok, d.reshape(E), 0.0).astype(np.float32)
    rect_rows = jnp.stack([plan.tminx, plan.tminy, plan.w_rect, plan.im])
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[name] = (a, kw, out)
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(jr, "expand_emission", spy("k8", jr.expand_emission))
    mp.setattr(jr, "align_rows", spy("k9", jr.align_rows))
    try:
        aligned, ids_aligned, wl = jr.expand_sort_align(
            [jnp.asarray(r) for r in table], jnp.asarray(depthf), plan.cnt, plan.cum_ex,
            plan.cum_in, rect_rows, plan.win_starts, plan.n_slots.reshape(1), cap_total, TW, TH, C,
        )
    finally:
        mp.undo()
    return dict(table=table, depthf=depthf, plan=plan, m2=m2, radii=radii, cap_total=cap_total,
                seen=seen, ids=np.asarray(ids_aligned)[np.asarray(wl.valid)], T=C * TW * TH)


def test_k8_plain_matches_jax_expand_emission(jax_pipeline):
    p = jax_pipeline
    plan, T = p["plan"], p["T"]
    key_j, depth_j, flat_j, fields_j = (np.asarray(x) for x in p["seen"]["k8"][2])
    R = p["table"].shape[0]
    rect = torch.from_numpy(np.stack([np.asarray(plan.tminx), np.asarray(plan.tminy),
                                      np.asarray(plan.w_rect), np.asarray(plan.im)]))
    keys, depth, flat, fields = tg.expand_emission_aabb(
        torch.from_numpy(np.array(plan.cum_in)), rect, torch.from_numpy(p["depthf"]),
        torch.from_numpy(p["table"]), torch.from_numpy(np.array(plan.n_slots).reshape(1)),
        p["cap_total"], TW, TW * TH, T,
    )
    np.testing.assert_array_equal(keys.numpy(), key_j)
    np.testing.assert_array_equal(fields.numpy(), fields_j[:R])
    live = key_j < T
    assert live.sum() == int(plan.n_isects) > 0
    np.testing.assert_array_equal(depth.numpy()[live], depth_j[live])
    np.testing.assert_array_equal(flat.numpy()[live], flat_j[live])
    assert np.isinf(depth.numpy()[~live]).all() and (flat.numpy()[~live] == 0).all()
    # the dummy slots lie before n_slots and carry the sentinel
    assert (~live[: int(plan.n_slots)]).sum() == int((np.asarray(plan.cnt) == 0).sum())


def test_k9_plain_matches_jax_align_rows(jax_pipeline):
    """On the JAX function's own padded, monotone source indices."""
    (rows, src, _win), kw, out = jax_pipeline["seen"]["k9"]
    src = np.array(src).reshape(-1)
    assert (src < 0).any() and (src >= 0).any()
    got = tg.align_rows(torch.from_numpy(np.array(rows)), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))


def test_sort_keeps_isect_tiles_order_for_equal_depths():
    """Surfels at one depth overlapping one tile: the port's stable (tile,
    depth) sort gives isect_tiles's order, emission order within a tie.  The
    JAX expand_sort_align sorts unstably (rasterize.py:1161-1163) and on the
    CPU gives another order within the ties (ROADMAP Queue 3)."""
    rng = np.random.default_rng(11)
    C, N = 1, 60
    m2 = rng.uniform(0, 32, (C, N, 2)).astype(np.float32)
    radii = np.full((C, N, 2), 9, np.int32)
    radii[0, :3] = 0  # culled: dummy slots
    depths = np.full((C, N), 2.0, np.float32)
    depths[0, ::4] = 3.0
    want = isect_tiles(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths), TS, 2, 2,
                       capacity=4096)
    n = int(want.n_isects)
    plan = tr.make_emission_plan(torch.from_numpy(m2), torch.from_numpy(radii), TS, 2, 2, 4608)
    table = torch.arange(N, dtype=torch.float32)[:, None]
    fields_s, bounds, order, flat = tr.expand_sort_align(table, torch.from_numpy(depths[0]), plan,
                                                         4608, 2, 2, C)
    assert int(bounds[-1]) == n
    got = flat[order][:n].numpy()
    np.testing.assert_array_equal(got, np.asarray(want.flatten_ids)[:n])
    np.testing.assert_array_equal(fields_s[0, :n].numpy(), got.astype(np.float32))
    np.testing.assert_array_equal(bounds[:-1].numpy(),
                                  np.searchsorted(np.asarray(want.tile_keys), np.arange(4)))
    jplan = jr.make_emission_plan(jnp.asarray(m2), jnp.asarray(radii), TS, 2, 2, 4608)
    rect = jnp.stack([jplan.tminx, jplan.tminy, jplan.w_rect, jplan.im])
    _, ids, wl = jr.expand_sort_align(
        [jnp.arange(N, dtype=jnp.float32)], jnp.asarray(depths[0]), jplan.cnt, jplan.cum_ex,
        jplan.cum_in, rect, jplan.win_starts, jplan.n_slots.reshape(1), 4608, 2, 2, C)
    j_ids = np.asarray(ids)[np.asarray(wl.valid)]
    assert j_ids.shape == got.shape and not np.array_equal(j_ids, got)
    tiles = np.asarray(want.tile_keys)[:n]
    for t in range(4):  # the same surfels in each tile, in another order
        np.testing.assert_array_equal(np.sort(j_ids[tiles == t]), np.sort(got[tiles == t]))


def test_reduce_slot_grads_matches_the_jax_reduction():
    """Per-gaussian sums over emission runs clamped to n_slots, as
    rasterize.py:1212-1215 takes them (runs of cnt real slots from cum_ex):
    truncated slots add nothing, and a dummy slot, which lies in no tile's
    span and so holds a zero gradient, adds nothing either."""
    rng = np.random.default_rng(3)
    m2 = torch.from_numpy(rng.uniform(0, 64, (1, 30, 2)).astype(np.float32))
    radii = torch.full((1, 30, 2), 10, dtype=torch.int32)
    radii[0, 5] = 0
    P = 64
    plan = tr.make_emission_plan(m2, radii, TS, 4, 3, P)
    assert bool(plan.overflow) and int(plan.cum_in[-1]) > P
    order = torch.randperm(P, generator=torch.Generator().manual_seed(0))
    v_emit = rng.standard_normal((2, P)).astype(np.float32)
    dummies = plan.cum_ex[plan.cnt == 0].numpy()
    v_emit[:, dummies[dummies < P]] = 0.0  # what K6b leaves there
    got = tr.reduce_slot_grads(torch.from_numpy(v_emit)[:, order], order, plan.cum_in,
                               plan.n_slots)
    cum_ex, cnt = plan.cum_ex.numpy(), plan.cnt.numpy()
    vrc = np.clip(np.minimum(cum_ex + cnt, P) - cum_ex, 0, cnt)
    want = np.stack([[v_emit[r, a : a + n].sum() for a, n in zip(cum_ex, vrc)] for r in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got[:, vrc == 0] == 0).all() and (vrc == 0).sum() > 1
