"""Port parity: tight plan, emission and rasterize_to_pixels vs the JAX package.

The same numpy inputs go through the JAX functions (Pallas in interpret
mode on the CPU, as the JAX suite runs them) and through the port on
device="cpu", where the kernel wrappers take their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gsplat_tpu.ops import gather_pallas as jgp
from gsplat_tpu.ops import rasterize as jr
from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref
from gsplat_tpu_torch.ops import gather_kernel as tg
from gsplat_tpu_torch.ops import rasterize as tr
from gsplat_tpu_torch.ops import rasterize_kernel as tk

W, H = 40, 35  # deliberately not tile multiples


def _scene(seed=0, I=2, N=150, D=3):
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-5, 45, (I, N, 2)).astype(np.float32)
    L = rng.standard_normal((I, N, 2, 2)).astype(np.float32) * 0.4
    cov = L @ L.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    colors = rng.random((I, N, D)).astype(np.float32)
    opacities = np.clip(rng.random((I, N)) * 1.2, 0, 1).astype(np.float32)
    radii = np.full((I, N, 2), 5, np.int32)
    radii[:, ::7] = 0
    conics[:, ::7] = np.nan  # culled rows may carry NaN; they must not leak
    depths = (rng.random((I, N)) * 5 + 0.1).astype(np.float32)
    return dict(means2d=means2d, conics=conics, colors=colors, opacities=opacities,
                radii=radii, depths=depths)


def _band_close(a, b, name, strict=3e-5, frac=0.05, hard=2e-4):
    """The JAX suite's band assert (tests/test_rasterize_pallas.py:67-81):
    the Pallas kernel's transmittance runs as exp(cumsum(log(1-a))) on split
    bf16 matmuls, ~1e-4-class absolute noise against a sequential product;
    most pixels sit within the strict bound, all within `hard`."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    bad = float((diff > strict).mean())
    assert bad < frac, (name, bad)
    assert float(diff.max()) < hard, (name, float(diff.max()))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _compacted(s):
    """Compaction order computed once with numpy and fed to both packages."""
    I, N = s["depths"].shape
    E = I * N
    rad = s["radii"].reshape(E, 2)
    alive = (rad > 0).all(-1)
    key = np.where(alive, s["depths"].reshape(E), np.inf)
    perm = np.argsort(key, kind="stable")
    D = s["colors"].shape[-1]
    return dict(
        perm=perm,
        m2=s["means2d"].reshape(E, 2)[perm], rad=rad[perm],
        cn=s["conics"].reshape(E, 3)[perm], op=s["opacities"].reshape(E)[perm],
        cl=s["colors"].reshape(E, D)[perm], im=(perm // N).astype(np.int32),
        n_live=np.int32(alive.sum()), I=I,
    )


@pytest.mark.parametrize("ts", [8, 16])
def test_tight_plan_matches_jax(ts):
    s = _scene()
    c = _compacted(s)
    tw, th = -(-W // ts), -(-H // ts)
    cap, row_cap = 4096, 2048
    jp = jr.make_tight_plan(
        jnp.asarray(c["m2"]), jnp.asarray(c["rad"]), jnp.asarray(c["cn"]),
        jnp.asarray(c["op"]), jnp.asarray(c["im"]), jnp.asarray(c["n_live"]),
        c["I"], ts, tw, th, cap, row_cap,
    )
    tp = tr.make_tight_plan(
        _t(c["m2"]), _t(c["rad"]), _t(c["cn"]), _t(c["op"]), _t(c["im"]),
        torch.tensor(c["n_live"]), c["I"], ts, tw, th, cap, row_cap,
    )
    rr = tp.rr.numpy()
    for row, name in ((tg.RR_X0, "rr_x0"), (tg.RR_TY, "rr_ty"), (tg.RR_IM, "rr_im"),
                      (tg.RR_GID, "rr_gid"), (tg.RR_IN, "rr_cum_in"), (tg.RR_EX, "rr_cum_ex")):
        np.testing.assert_array_equal(rr[row], np.asarray(getattr(jp, name)), err_msg=name)
    assert int(tp.n_isects) == int(jp.n_isects) > 0
    assert int(tp.n_slots[0]) == int(jp.n_slots[0])
    assert bool(tp.overflow) == bool(jp.overflow) is False
    np.testing.assert_array_equal(tp.dummy.numpy(), np.asarray(jp.dummy))


def test_emission_matches_jax():
    s = _scene(seed=3)
    c = _compacted(s)
    ts, D = 16, 3
    tw, th = -(-W // ts), -(-H // ts)
    cap, row_cap = 4096, 2048
    I = c["I"]
    T = I * tw * th
    args = (c["m2"], c["rad"], c["cn"], c["op"], c["im"], c["n_live"])
    jp = jr.make_tight_plan(*map(jnp.asarray, args), I, ts, tw, th, cap, row_cap)
    tp = tr.make_tight_plan(*map(_t, args[:5]), torch.tensor(c["n_live"]), I, ts, tw, th,
                            cap, row_cap)

    dummy_i = jp.dummy.astype(jnp.int32)
    rows = [c["m2"][:, 0], c["m2"][:, 1], c["cn"][:, 0], c["cn"][:, 1], c["cn"][:, 2], c["op"]]
    rows += [c["cl"][:, i] for i in range(D)]
    table_g = jr._build_field_table([jnp.asarray(r) for r in rows], dummy_i)
    rr_geo = jnp.stack([jp.rr_x0, jp.rr_ty, jp.rr_im, jp.rr_gid])
    table_rr = jr._build_rr_table(jp.rr_cum_ex, jp.rr_cum_in, rr_geo, I)
    jkeys, jfields = jgp.expand_emission2(
        table_rr, table_g, jp.win1, jp.win2, jp.n_slots, n_render=6 + D,
        r_pad=jr._round_up(6 + D + 2, 8), tile_w=tw, tiles_per_im=tw * th,
        sentinel=T, k=cap // jgp.CH,
    )

    comp = tr.Compacted(
        perm=_t(c["perm"]), means2d=_t(c["m2"]), radii=_t(c["rad"]), conics=_t(c["cn"]),
        opacities=_t(c["op"]), colors=_t(c["cl"]), image_ids=_t(c["im"]),
        n_live=torch.tensor(c["n_live"]),
    )
    tkeys, tfields = tg.expand_emission(
        tp.rr, tr.field_table(comp, tp.dummy), tp.n_slots, cap, tw, tw * th, T
    )
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(tfields.numpy(), np.asarray(jfields)[: 6 + D])
    assert np.isfinite(tfields.numpy()).all()


def _render_both(s, cap, ts=16, bg=None, masks=None, row_capacity=None):
    args = [s[k] for k in ("means2d", "conics", "colors", "opacities")]
    jc, ja, jaux = jr.rasterize_to_pixels(
        *map(jnp.asarray, args), W, H, jnp.asarray(s["radii"]), jnp.asarray(s["depths"]),
        cap, backgrounds=None if bg is None else jnp.asarray(bg),
        masks=None if masks is None else jnp.asarray(masks), tile_size=ts,
        row_capacity=row_capacity,
    )
    tc, ta, taux = tr.rasterize_to_pixels(
        *map(_t, args), W, H, _t(s["radii"]), _t(s["depths"]), cap,
        backgrounds=None if bg is None else _t(bg),
        masks=None if masks is None else _t(masks), tile_size=ts,
        row_capacity=row_capacity,
    )
    return (jc, ja, jaux), (tc, ta, taux)


def _check_aux(jaux, taux):
    assert int(taux["n_isects"]) == int(jaux["n_isects"])
    assert bool(taux["isect_overflow"]) == bool(jaux["isect_overflow"])
    np.testing.assert_array_equal(taux["tiles_per_gauss"].numpy(),
                                  np.asarray(jaux["tiles_per_gauss"]))


def _oracle(s, ts, bg=None, masks=None):
    """The JAX oracle (rasterize_ref.py) on the same scene."""
    I = s["means2d"].shape[0]
    tw, th = -(-W // ts), -(-H // ts)
    isect = isect_tiles(jnp.asarray(s["means2d"]), jnp.asarray(s["radii"]),
                        jnp.asarray(s["depths"]), ts, tw, th, capacity=8192)
    offsets = isect_offset_encode(isect.tile_keys, I, tw, th)
    return rasterize_to_pixels_ref(
        *(jnp.asarray(np.nan_to_num(s[k])) for k in ("means2d", "conics", "colors", "opacities")),
        W, H, ts, offsets, isect.flatten_ids, isect.n_isects, max_range=1024,
        backgrounds=None if bg is None else jnp.asarray(bg),
        masks=None if masks is None else jnp.asarray(masks),
    )


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_rasterize_matches_jax(ts):
    s = _scene()
    I, D = 2, 3
    bg = np.random.default_rng(1).random((I, D)).astype(np.float32)
    masks = np.ones((I, -(-H // ts), -(-W // ts)), bool)
    masks[0, 0, 1] = False
    (jc, ja, jaux), (tc, ta, taux) = _render_both(s, 4096, ts=ts, bg=bg, masks=masks)
    # Against the Pallas path: the JAX suite's own band, whose hard bound it
    # scales with the span growth at larger tiles (test_rasterize_pallas.py:
    # test_tile_size_variants_match_oracle, measured 4.5e-4 at ts=32).
    hard = 2e-4 * max(1.0, (ts / 16.0) ** 2)
    _band_close(tc.numpy(), jc, "colors", hard=hard)
    _band_close(ta.numpy(), ja, "alphas", hard=hard)
    # Against the oracle the port differs only by f32 summation order.
    rc, ra = _oracle(s, ts, bg=bg, masks=masks)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ra), atol=1e-6, rtol=0)
    _check_aux(jaux, taux)
    assert not bool(taux["isect_overflow"])
    # the masked tile shows pure background with zero alpha
    blk = tc.numpy()[0, :ts, ts : 2 * ts]
    np.testing.assert_array_equal(blk, np.broadcast_to(bg[0], blk.shape))
    assert (ta.numpy()[0, :ts, ts : 2 * ts] == 0).all()


def test_rasterize_overflow_matches_jax():
    """Truncated capacities: both packages drop the same slots and flag it."""
    s = _scene(seed=5, N=600)  # ~1.4k tight slots against 512 of capacity
    (jc, ja, jaux), (tc, ta, taux) = _render_both(s, 512, ts=8)
    assert bool(taux["isect_overflow"]) and bool(jaux["isect_overflow"])
    _check_aux(jaux, taux)
    _band_close(tc.numpy(), jc, "colors")
    _band_close(ta.numpy(), ja, "alphas")


def test_empty_input():
    m2 = torch.zeros((1, 8, 2))
    cn = torch.tensor([1.0, 0.0, 1.0]).repeat(1, 8, 1)
    c, a, aux = tr.rasterize_to_pixels(
        m2, cn, torch.zeros((1, 8, 3)), torch.zeros((1, 8)), W, H,
        torch.zeros((1, 8, 2), dtype=torch.int32), torch.ones((1, 8)), 128,
    )
    assert int(aux["n_isects"]) == 0
    assert (c == 0).all() and (a == 0).all()


def test_chunk_resume_scene_follows_oracle():
    """A pixel stops for good at the gaussian that saturates it.

    300 broad gaussians centred on one 16x16 tile, front to back: slots
    0-253 at opacity 0.02, slot 254 at 0.99 (it would take T below 1e-4),
    slots 255+ red at 0.5.  The JAX oracle and upstream gsplat stop the
    centre pixel at slot 254; the JAX Pallas kernel resumes it in the next
    256-slot chunk (a known gap of the reference, ROADMAP Queue 3).  The
    port follows the oracle.
    """
    N, S = 300, 16
    means2d = np.full((1, N, 2), 8.0, np.float32)
    conics = np.tile(np.array([0.01, 0.0, 0.01], np.float32), (1, N, 1))
    op = np.full((1, N), 0.02, np.float32)
    op[0, 254] = 0.99
    op[0, 255:] = 0.5
    colors = np.zeros((1, N, 3), np.float32)
    colors[0, :255, 1] = 1.0
    colors[0, 255:, 0] = 1.0
    depths = np.linspace(1.0, 2.0, N, dtype=np.float32)[None]
    radii = np.full((1, N, 2), 8, np.int32)

    isect = isect_tiles(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
                        S, 1, 1, capacity=1024)
    offsets = isect_offset_encode(isect.tile_keys, 1, 1, 1)
    rc, ra = rasterize_to_pixels_ref(
        jnp.asarray(means2d), jnp.asarray(conics), jnp.asarray(colors), jnp.asarray(op),
        S, S, S, offsets, isect.flatten_ids, isect.n_isects, max_range=512,
    )
    assert float(rc[0, 8, 8, 0]) == 0.0
    tc, ta, _ = tr.rasterize_to_pixels(
        _t(means2d), _t(conics), _t(colors), _t(op), S, S, _t(radii), _t(depths), 1024,
    )
    _band_close(tc.numpy(), rc, "colors")
    _band_close(ta.numpy(), ra, "alphas")
    assert float(tc[0, 8, 8, 0]) == 0.0  # no red behind the saturating gaussian
    # the JAX Pallas path resumes the pixel in the next chunk (the known gap)
    jc, ja, _ = jr.rasterize_to_pixels(
        *map(jnp.asarray, (means2d, conics, colors, op)), S, S, jnp.asarray(radii),
        jnp.asarray(depths), 1024,
    )
    assert float(jc[0, 8, 8, 0]) > 1e-3 and float(ja[0, 8, 8, 0]) > float(ra[0, 8, 8, 0])


def test_plain_transmittance_is_a_serial_float32_product():
    """The plain composite's T is the kernel's serial float32 product, bit
    for bit (numpy's accumulate runs in the array's dtype, front to back)."""
    x = np.random.default_rng(3).uniform(0.5, 1.0, (3, 4, 300)).astype(np.float32)
    got = tk._serial_cumprod(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.multiply.accumulate(x, axis=-1))


def test_plain_composite_batches_agree():
    """The plain composite gives the same image whatever its tile batching."""
    s = _scene(seed=7)
    c = _compacted(s)
    ts = 8
    tw, th = -(-W // ts), -(-H // ts)
    tp = tr.make_tight_plan(*map(_t, (c["m2"], c["rad"], c["cn"], c["op"], c["im"])),
                            torch.tensor(c["n_live"]), 2, ts, tw, th, 4096, 2048)
    comp = tr.Compacted(_t(c["perm"]), _t(c["m2"]), _t(c["rad"]), _t(c["cn"]), _t(c["op"]),
                        _t(c["cl"]), _t(c["im"]), torch.tensor(c["n_live"]))
    keys, fields = tg.expand_emission(tp.rr, tr.field_table(comp, tp.dummy), tp.n_slots,
                                      4096, tw, tw * th, 2 * tw * th)
    fs, bounds = tr.sort_slots(keys, fields, 2 * tw * th)
    full = tk.rasterize_fwd(fs, bounds, 2, ts, tw, th, W, H)
    budget = tk._PLAIN_BUDGET
    try:
        tk._PLAIN_BUDGET = 1  # one tile per batch
        one = tk.rasterize_fwd(fs, bounds, 2, ts, tw, th, W, H)
    finally:
        tk._PLAIN_BUDGET = budget
    for a, b in zip(full, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    pairs = chip_smoke.evaluated_pairs(fs, bounds, 2, ts, tw, th, W, H)
    counts = (bounds[1:] - bounds[:-1]).long()
    assert 0 < pairs <= int(counts.sum()) * ts * ts
