"""Port parity: the packed modes (bf16-pair payload and gradients) and the
inference fast path against the JAX package.

The same numpy inputs go through the JAX functions (Pallas in interpret mode
on the CPU, as the JAX suite runs them) and through the port on the CPU,
where the kernel wrappers take their plain versions.

Tolerances, and why:
- Carriers and the packed emission: bit for bit.  Both round float32 to
  bfloat16 to nearest, ties to even.
- The fast path against the JAX fast path and against the exact path: the
  JAX suite's class for the fast path, mean < 5e-3 and 99.9% < 0.05
  (tests/test_fast_inference.py:62-68).  The port composites the unpacked
  values in float32 as its exact path does; the JAX fast kernel evaluates
  sigma as an expanded quadratic around the tile origin with a faithful
  2-split of its coefficients (rasterize_pallas.py:_chunk_alphas fast=True),
  whose error grows with the square of the tile size (measured up to 1.3e-3
  of a pixel at tile 16 on the scene below), so the exact-path band of
  tests/test_torch_rasterize.py does not hold between the two.
- Where the tile-local frame is the image's own (one tile at the origin),
  the packed paths are held to the JAX oracle run on the unpacked carriers:
  1e-6 for images, as the exact path against the oracle, and 3e-4 of each
  array's scale for gradients (tests/test_torch_rasterize_bwd.py); 2^-8 of
  it with pack_grads, which rounds each per-slot gradient to bf16 before the
  per-gaussian sums.
- Gradients against jax.grad of the JAX op with the same flags: the JAX
  suite's pack_grads band (tests/test_rasterize_pallas.py:288-295): under
  3% of the entries off by more than 5e-3 of the array's scale, none by more
  than 0.1 of it.  The JAX packed replay carries the fast kernel's sigma
  error into its gradients (measured up to 1.8e-2 of the scale for the
  means), so the exact path's 3e-4 does not hold there either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import gather_pallas as jgp
from gsplat_tpu.ops import mxu
from gsplat_tpu.ops import rasterize as jr
from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref
from gsplat_tpu_torch.ops import bf16pair as tb
from gsplat_tpu_torch.ops import gather_kernel as tg
from gsplat_tpu_torch.ops import rasterize as tr

NAMES = ("means2d", "conics", "colors", "opacities")


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _fast_class(a, b, name):
    """The JAX suite's class for the fast path (test_fast_inference.py:62-68)."""
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert diff.mean() < 5e-3, (name, diff.mean())
    assert np.quantile(diff, 0.999) < 0.05, (name, np.quantile(diff, 0.999))


def _scene(n=500, seed=0, W=96, H=64, I=2, D=3):
    """The scene of tests/test_fast_inference.py:22-34 (with D channels)."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-8, [W + 8, H + 8], (I, n, 2)).astype(np.float32)
    a = rng.uniform(0.01, 1.0, (I, n)).astype(np.float32)
    c = rng.uniform(0.01, 1.0, (I, n)).astype(np.float32)
    b = (rng.uniform(-0.9, 0.9, (I, n)) * np.sqrt(a * c)).astype(np.float32)
    colors = rng.uniform(0, 1, (I, n, 3)).astype(np.float32)
    if D == 4:
        colors = np.concatenate([colors, colors[..., :1]], axis=-1)
    return dict(
        means2d=means2d, conics=np.stack([a, b, c], -1), colors=colors,
        opacities=rng.uniform(0.05, 0.95, (I, n)).astype(np.float32),
        depths=rng.uniform(0.5, 10, (I, n)).astype(np.float32),
        radii=np.full((I, n, 2), 6, np.int32), W=W, H=H,
    )


def _args(s, conv):
    return [conv(s[k]) for k in NAMES] + [s["W"], s["H"], conv(s["radii"]), conv(s["depths"])]


# ---------------------------------------------------------------------------
# carriers
# ---------------------------------------------------------------------------

EDGES = np.concatenate([
    np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1e-45, 1.1754942e-38, 3.4028235e38,
              -3.4028235e38, 1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8], np.float32),
    # exact ties below the bf16 mantissa: even and odd neighbours, denormal and largest
    np.array([0x3F808000, 0x3F818000, 0x00008000, 0x00018000, 0x7F7F8000, 0x80008000],
             np.uint32).view(np.float32),
])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_carriers_equal_the_jax_carriers_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale * 1000) % 97)
    hi = (rng.standard_normal((3, 300)) * scale).astype(np.float32)
    lo = (rng.standard_normal((3, 300)) * scale).astype(np.float32)
    got = tb.pack_bf16_pair(_t(hi), _t(lo)).numpy()
    want = np.asarray(mxu.pack_bf16_pair(jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for g, w in zip(tb.unpack_bf16_pair(_t(want)), mxu.unpack_bf16_pair(jnp.asarray(want))):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_carrier_edge_values_equal_the_jax_carriers():
    """Ties to even, -0, +-inf, f32 denormals, overflow past the largest bf16."""
    hi, lo = EDGES, EDGES[::-1].copy()
    got = tb.pack_bf16_pair(_t(hi), _t(lo)).numpy()
    want = np.asarray(mxu.pack_bf16_pair(jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    h, l = tb.unpack_bf16_pair(_t(got))
    np.testing.assert_array_equal(np.signbit(h.numpy()), np.signbit(hi))
    assert (h.numpy()[4:6] != 0).all()  # bf16 keeps f32 denormals


def test_rows_pack_in_pairs_and_zero_bits_unpack_to_zeros():
    rows = torch.randn(9, 4, 5, generator=torch.Generator().manual_seed(0))
    packed = tb.pack_rows(rows)
    assert packed.shape == (tb.grad_pack_rows(3), 4, 5) == (tb.packed_rows(3), 4, 5)
    back = tb.unpack_rows(packed, 9)
    np.testing.assert_array_equal(back.numpy(), rows.to(torch.bfloat16).float().numpy())
    # the odd last row is paired with zero
    assert (tb.unpack_bf16_pair(packed[-1])[1] == 0).all()
    zero = tb.unpack_payload(torch.zeros(tb.packed_rows(4), 7), 4)
    assert zero.shape == (10, 7) and (zero == 0).all() and not torch.signbit(zero).any()


# ---------------------------------------------------------------------------
# K4 packed: the emission and its sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("D", [3, 4])
def test_packed_emission_equals_the_jax_emission_bit_for_bit(ts, D):
    s = _scene(n=150, seed=3, W=40, H=35, D=D)
    s["radii"][:, ::7] = 0
    s["conics"][:, ::7] = np.nan  # culled rows may carry NaN; they must not leak
    I, N = s["depths"].shape
    E = I * N
    rad = s["radii"].reshape(E, 2)
    alive = (rad > 0).all(-1)
    perm = np.argsort(np.where(alive, s["depths"].reshape(E), np.inf), kind="stable")
    m2, cn = s["means2d"].reshape(E, 2)[perm], s["conics"].reshape(E, 3)[perm]
    op, cl = s["opacities"].reshape(E)[perm], s["colors"].reshape(E, D)[perm]
    im, n_live = (perm // N).astype(np.int32), np.int32(alive.sum())
    tw, th = -(-s["W"] // ts), -(-s["H"] // ts)
    T, cap, row_cap = I * tw * th, 4096, 2048
    geo = (m2, rad[perm], cn, op, im)
    jp = jr.make_tight_plan(*map(jnp.asarray, geo), jnp.asarray(n_live), I, ts, tw, th, cap,
                            row_cap)
    rows = [m2[:, 0], m2[:, 1], cn[:, 0], cn[:, 1], cn[:, 2], op] + [cl[:, i] for i in range(D)]
    table_g = jr._build_field_table([jnp.asarray(r) for r in rows], jp.dummy.astype(jnp.int32))
    rr_geo = jnp.stack([jp.rr_x0, jp.rr_ty, jp.rr_im, jp.rr_gid])
    R = tb.packed_rows(D)
    jkeys, jfields = jgp.expand_emission2(
        jr._build_rr_table(jp.rr_cum_ex, jp.rr_cum_in, rr_geo, I), table_g, jp.win1, jp.win2,
        jp.n_slots, n_render=6 + D, r_pad=jr._round_up(R + 2, 8), tile_w=tw,
        tiles_per_im=tw * th, sentinel=T, k=cap // jgp.CH, packed=True, tile_size=ts,
    )
    # the JAX forward's sort: by (key, emission position)
    srt = jax.lax.sort((jkeys, jnp.arange(cap, dtype=jnp.int32))
                       + tuple(jfields[i] for i in range(R)), num_keys=2)

    tp = tr.make_tight_plan(*map(_t, geo), torch.tensor(n_live), I, ts, tw, th, cap, row_cap)
    comp = tr.Compacted(_t(perm), _t(m2), _t(rad[perm]), _t(cn), _t(op), _t(cl), _t(im),
                        torch.tensor(n_live))
    keys, fields = tg.expand_emission(tp.rr, tr.field_table(comp, tp.dummy), tp.n_slots, cap,
                                      tw, tw * th, T, packed=True, tile_size=ts)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(_bits(fields.numpy()), _bits(np.asarray(jfields)[:R]))
    fields_s, bounds, _ = tr.sort_slots(keys, fields, T)
    np.testing.assert_array_equal(_bits(fields_s.numpy()), _bits(np.stack(srt[2:])))
    assert fields.shape == (R, cap) and int(bounds[-1]) > 0
    # tile-local means lie within the tight plan's reach of their tile
    x_loc = tb.unpack_payload(fields_s[:, : int(bounds[-1])], D)[:2]
    assert float(x_loc.abs().max()) < 4 * ts
    # empty slots are zero bits
    assert (_bits(fields.numpy())[:, int(tp.n_slots[0]):] == 0).all()


# ---------------------------------------------------------------------------
# the fast path and pack_payload / pack_grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("D", [3, 4])
def test_fast_path_matches_jax_and_the_exact_path(D, ts):
    s = _scene(D=D)
    jc, ja, jaux = jr.rasterize_to_pixels_fast(*_args(s, jnp.asarray), isect_capacity=300_000,
                                               tile_size=ts)
    tc, ta, taux = tr.rasterize_to_pixels_fast(*_args(s, _t), 300_000, tile_size=ts)
    assert not bool(taux["isect_overflow"])
    assert int(taux["n_isects"]) == int(jaux["n_isects"]) > 0
    assert "tiles_per_gauss" not in taux
    _fast_class(tc.numpy(), jc, "colors against the JAX fast path")
    _fast_class(ta.numpy(), ja, "alphas against the JAX fast path")
    ec, ea, _ = tr.rasterize_to_pixels(*_args(s, _t), 300_000, tile_size=ts)
    _fast_class(tc.numpy(), ec.numpy(), "colors against the exact path")
    _fast_class(ta.numpy(), ea.numpy(), "alphas against the exact path")
    assert float(np.abs(tc.numpy() - ec.numpy()).max()) > 0  # the payload is quantized


def test_fast_path_background_empty_input_and_repeats():
    s = _scene(n=50, W=48, H=32, I=1)
    bg = np.array([[0.2, 0.4, 0.6]], np.float32)
    args = _args(s, _t)
    c1, a1, _ = tr.rasterize_to_pixels_fast(*args, 60_000, backgrounds=_t(bg))
    c2, a2, _ = tr.rasterize_to_pixels_fast(*args, 60_000, backgrounds=_t(bg))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)  # bit-stable across calls
    jc, ja, _ = jr.rasterize_to_pixels_fast(*_args(s, jnp.asarray), isect_capacity=60_000,
                                            backgrounds=jnp.asarray(bg))
    _fast_class(c1.numpy(), jc, "colors with a background")
    c0, a0, _ = tr.rasterize_to_pixels_fast(*args, 60_000)
    np.testing.assert_allclose(c1.numpy(), (c0 + (1 - a0) * _t(bg)[:, None, None]).numpy(),
                               atol=1e-6)
    # cull everything: pure background, zero alpha
    args[6] = torch.zeros_like(args[6])
    c, a, aux = tr.rasterize_to_pixels_fast(*args, 60_000, backgrounds=_t(bg))
    assert int(aux["n_isects"]) == 0 and (a == 0).all()
    np.testing.assert_array_equal(c.numpy(), np.broadcast_to(bg[0], c.shape))


def test_pack_payload_forward_equals_the_fast_path():
    """The training forward with pack_payload composites the same packed
    payload as the fast path, bit for bit (the JAX suite's
    test_pack_payload_forward_matches_fast_path)."""
    s = _scene(n=300, W=64, H=48)
    c_pk, a_pk, _ = tr.rasterize_to_pixels(*_args(s, _t), 20_000, pack_payload=True)
    c_fast, a_fast, _ = tr.rasterize_to_pixels_fast(*_args(s, _t), 20_000)
    assert torch.equal(c_pk, c_fast) and torch.equal(a_pk, a_fast)


def test_pack_grads_alone_keeps_the_exact_forward():
    s = _scene(n=300, W=64, H=48)
    leaves = [_t(s[k]).requires_grad_() for k in NAMES]
    args = leaves + _args(s, _t)[4:]
    c0, a0, _ = tr.rasterize_to_pixels(*args, 20_000)
    c1, a1, _ = tr.rasterize_to_pixels(*args, 20_000, pack_grads=True)
    assert torch.equal(c0, c1) and torch.equal(a0, a1)


def _target(shape, seed=2):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _torch_grads(s, cap, pack_payload, pack_grads, ts=16):
    leaves = [_t(s[k]).requires_grad_() for k in NAMES]
    c, a, _ = tr.rasterize_to_pixels(*leaves, *_args(s, _t)[4:], cap, tile_size=ts,
                                     pack_payload=pack_payload, pack_grads=pack_grads)
    (((c - _t(_target(tuple(c.shape)))) ** 2).sum() + 0.3 * a.sum()).backward()
    return [x.grad.numpy() for x in leaves], c.detach().numpy()


def _jax_grads(s, cap, pack_payload, pack_grads, ts=16):
    I = s["depths"].shape[0]
    tgt = jnp.asarray(_target((I, s["H"], s["W"], s["colors"].shape[-1])))
    rest = _args(s, jnp.asarray)[4:]

    def loss(*x):
        c, a, _ = jr.rasterize_to_pixels(*x, *rest, cap, tile_size=ts, pack_payload=pack_payload,
                                         pack_grads=pack_grads)
        return jnp.sum((c - tgt) ** 2) + 0.3 * jnp.sum(a)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(s[k]) for k in NAMES))
    return [np.asarray(x) for x in g]


@pytest.mark.parametrize("pack_payload,pack_grads", [(True, False), (False, True), (True, True)])
def test_packed_gradients_match_jax(pack_payload, pack_grads):
    s = _scene(n=150, seed=1, W=40, H=35)
    got, _ = _torch_grads(s, 4096, pack_payload, pack_grads)
    want = _jax_grads(s, 4096, pack_payload, pack_grads)
    exact, _ = _torch_grads(s, 4096, False, False)
    for name, g, w, e in zip(NAMES, got, want, exact):
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        scale = max(float(np.abs(w).max()), 1e-3)
        diff = np.abs(g - w)
        assert float((diff > 5e-3 * scale).mean()) < 0.03, (name, diff.max() / scale)
        assert float(diff.max()) < 0.1 * scale, (name, diff.max() / scale)
        assert not np.array_equal(g, e), name  # a packed mode changes the gradients


# ---------------------------------------------------------------------------
# one tile at the origin: the packed paths against the oracle on the carriers
# ---------------------------------------------------------------------------


def _unpacked_carriers(s):
    """The fields as the packed payload carries them for a tile at the origin,
    where tile-local coordinates are the image's own: each rounded to bf16."""
    return {k: _t(s[k]).to(torch.bfloat16).float().numpy() if k in NAMES else s[k] for k in s}


def _oracle(s, ts, grads=False):
    I = s["means2d"].shape[0]
    isect = isect_tiles(jnp.asarray(s["means2d"]), jnp.asarray(s["radii"]),
                        jnp.asarray(s["depths"]), ts, 1, 1, capacity=2048)
    offsets = isect_offset_encode(isect.tile_keys, I, 1, 1)
    tgt = jnp.asarray(_target((I, s["H"], s["W"], s["colors"].shape[-1])))

    def render(*x):
        return rasterize_to_pixels_ref(*x, s["W"], s["H"], ts, offsets, isect.flatten_ids,
                                       isect.n_isects, max_range=1024)

    x = [jnp.asarray(s[k]) for k in NAMES]
    if not grads:
        return [np.asarray(v) for v in render(*x)]

    def loss(*x):
        c, a = render(*x)
        return jnp.sum((c - tgt) ** 2) + 0.3 * jnp.sum(a)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(*x)]


def _saturating_tile():
    """The chunk-resume scene of tests/test_torch_rasterize.py:224: 300 broad
    gaussians on one 16x16 tile, slot 254 saturates the centre pixel, slots
    255+ are red."""
    N = 300
    op = np.full((1, N), 0.02, np.float32)
    op[0, 254] = 0.99
    op[0, 255:] = 0.5
    colors = np.zeros((1, N, 3), np.float32)
    colors[0, :255, 1] = 1.0
    colors[0, 255:, 0] = 1.0
    return dict(means2d=np.full((1, N, 2), 8.0, np.float32),
                conics=np.tile(np.array([0.01, 0.0, 0.01], np.float32), (1, N, 1)),
                colors=colors, opacities=op,
                depths=np.linspace(1.0, 2.0, N, dtype=np.float32)[None],
                radii=np.full((1, N, 2), 8, np.int32), W=16, H=16)


@pytest.mark.parametrize("which", ["random", "saturating"])
def test_one_tile_packed_paths_follow_the_oracle_on_the_carriers(which):
    if which == "random":
        s = _scene(n=120, seed=5, W=16, H=16, I=1)
        s["means2d"] = np.clip(s["means2d"], 0.0, 16.0)
    else:
        s = _saturating_tile()
    q = _unpacked_carriers(s)
    rc, ra = _oracle(q, 16)
    tc, ta, _ = tr.rasterize_to_pixels_fast(*_args(s, _t), 2048)
    np.testing.assert_allclose(tc.numpy(), rc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ta.numpy(), ra, atol=1e-6, rtol=0)
    if which == "saturating":  # the pixel stops for good: no red behind slot 254
        assert float(rc[0, 8, 8, 0]) == 0.0 and float(tc[0, 8, 8, 0]) == 0.0
    for pack_grads in (False, True):
        got, c = _torch_grads(s, 2048, True, pack_grads)
        np.testing.assert_array_equal(c, tc.numpy())
        for name, g, w in zip(NAMES, got, _oracle(q, 16, grads=True)):
            scale = max(float(np.abs(w).max()), 1.0)
            # pack_grads rounds each per-slot gradient to bf16 (2^-9) before the
            # per-gaussian sum
            tol = (2**-8 if pack_grads else 3e-4) * scale
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{which} {name}")


def test_the_jax_fast_path_drops_a_gaussian_centre_at_tile_32():
    """A fault of the reference (ROADMAP Queue 3): at tile 32 the JAX fast
    kernel's expanded-quadratic sigma, rounded through a faithful 2-split,
    comes out below the -2e-3 tolerance 0.2 px from a sharp gaussian's
    centre, which is then gated: alpha 0.10 where the exact path has 0.88.
    The port composites the unpacked values directly and keeps it."""
    s = _scene()
    ts, (i, y, x) = 32, (1, 18, 22)
    jc, ja, _ = jr.rasterize_to_pixels_fast(*_args(s, jnp.asarray), isect_capacity=300_000,
                                            tile_size=ts)
    ec, ea, _ = tr.rasterize_to_pixels(*_args(s, _t), 300_000, tile_size=ts)
    tc, ta, _ = tr.rasterize_to_pixels_fast(*_args(s, _t), 300_000, tile_size=ts)
    assert float(ea[i, y, x, 0]) - float(np.asarray(ja)[i, y, x, 0]) > 0.5
    assert abs(float(ta[i, y, x, 0]) - float(ea[i, y, x, 0])) < 5e-3
