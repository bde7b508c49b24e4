"""Port parity: the 2DGS rasterizer against gsplat_tpu's oracle
(rasterize_to_pixels_2dgs_ref through isect_tiles) and its Pallas path (in
interpret mode), forward and backward, on the scene of tests/test_2dgs.py.

Tolerances are the JAX suite's own (tests/test_2dgs.py:98-102, :147-151):
images within 2e-4, gradients within 2e-3 of each input's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.projection2d import fully_fused_projection_2dgs as jproj
from gsplat_tpu.ops.rasterize2d import rasterize_to_pixels_2dgs as j_r2d
from gsplat_tpu.ops.rasterize2d_ref import rasterize_to_pixels_2dgs_ref
from gsplat_tpu.rendering import rasterization_2dgs as j_rast2d
from gsplat_tpu_torch.ops import rasterize2d_kernel as t2k
from gsplat_tpu_torch.ops.rasterize2d import rasterize_to_pixels_2dgs
from gsplat_tpu_torch.rendering import rasterization_2dgs

from test_torch_projection2d import ARGS, H, W, surfel_scene

TS = 16
IMAGES = ("colors", "alphas", "normals", "distort", "median")


def _t(x):
    return torch.from_numpy(np.array(x))


def _oracle(m2, M, feats, nrm, op, radii, d, width=W, height=H):
    C = m2.shape[0]
    tw, th = -(-width // TS), -(-height // TS)
    isect = isect_tiles(m2, radii, d, TS, tw, th, capacity=16384)
    off = isect_offset_encode(isect.tile_keys, C, tw, th)
    return rasterize_to_pixels_2dgs_ref(m2, M, feats, nrm, op, width, height, TS, off,
                                        isect.flatten_ids, isect.n_isects, max_range=512)


@pytest.fixture(scope="module")
def projected():
    s = surfel_scene()
    radii, m2, d, M, nrm = jproj(*(jnp.asarray(s[k]) for k in ARGS), W, H)
    C, N = m2.shape[:2]
    feats = jnp.concatenate([jnp.broadcast_to(jnp.asarray(s["colors"])[None], (C, N, 3)),
                             d[..., None]], axis=-1)
    op = jnp.broadcast_to(jnp.asarray(s["opacities"])[None], (C, N))
    return dict(radii=radii, m2=m2, d=d, M=M, nrm=nrm, feats=feats, op=op)


def _port(p, **kw):
    C, N = p["m2"].shape[:2]
    return rasterize_to_pixels_2dgs(_t(p["m2"]), _t(p["M"]).reshape(C, N, 9), _t(p["feats"]),
                                    _t(p["nrm"]), _t(p["op"]), W, H, _t(p["radii"]), _t(p["d"]),
                                    16384, **kw)


def test_forward_matches_oracle_and_pallas(projected):
    p = projected
    args = (p["m2"], p["M"], p["feats"], p["nrm"], p["op"])
    ref = _oracle(*args, p["radii"], p["d"])
    C, N = p["m2"].shape[:2]
    pal = j_r2d(p["m2"], p["M"].reshape(C, N, 9), p["feats"], p["nrm"], p["op"], W, H,
                p["radii"], p["d"], 16384)
    got = _port(p)
    for name, g, r, q in zip(IMAGES, got, ref, pal):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(q), rtol=0, atol=2e-4, err_msg=name)
    aux = got[5]
    assert int(aux["n_isects"]) == int(pal[5]["n_isects"]) and not bool(aux["isect_overflow"])
    np.testing.assert_array_equal(aux["tiles_per_gauss"].numpy(), np.asarray(pal[5]["tiles_per_gauss"]))
    assert float(got[4].max()) > 0 and float(got[3].max()) > 0


def test_gradients_match_oracle(projected):
    """Every input's gradient, the median's and the densify carrier's, against
    jax.grad of the oracle; the carrier's reference is the JAX rule
    (v_u.z * w.z, v_v.z * w.z) on the oracle's ray-transform gradient."""
    p = projected
    C, N = p["m2"].shape[:2]
    rng = np.random.default_rng(3)
    tgt = rng.random((C, H, W, 4)).astype(np.float32)
    tgt_n = rng.random((C, H, W, 3)).astype(np.float32)
    tgt_m = (rng.random((C, H, W, 1)) * 8).astype(np.float32)

    def loss(c, a, n, dist, med, xp, conv):
        return (xp.sum((c - conv(tgt)) ** 2) + 0.2 * xp.sum(a) + xp.sum((n - conv(tgt_n)) ** 2)
                + 0.05 * xp.sum(dist) + 0.3 * xp.sum((med - conv(tgt_m)) ** 2))

    def jloss(m2, M, feats, nrm, op):
        return loss(*_oracle(m2, M, feats, nrm, op, p["radii"], p["d"]), jnp, jnp.asarray)

    names = ("means2d", "ray_transforms", "colors", "normals", "opacities")
    want = jax.grad(jloss, argnums=tuple(range(5)))(*(p[k] for k in ("m2", "M", "feats", "nrm", "op")))
    xs = [_t(p[k]).requires_grad_() for k in ("m2", "M", "feats", "nrm", "op")]
    dens = torch.zeros((C, N, 2), requires_grad=True)
    out = rasterize_to_pixels_2dgs(xs[0], xs[1].reshape(C, N, 9), *xs[2:], W, H, _t(p["radii"]),
                                   _t(p["d"]), 16384, densify=dens)
    loss(*out[:5], torch, torch.from_numpy).backward()
    for name, x, w in zip(names, xs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=2e-3 * np.abs(w).max(),
                                   err_msg=name)
    # the median's gradient lands on the depth channel of the median surfels
    gM = np.asarray(want[1]).reshape(C, N, 9)
    Mz = np.asarray(p["M"]).reshape(C, N, 9)[..., 8]
    w = np.stack([gM[..., 2] * Mz, gM[..., 5] * Mz], axis=-1)
    np.testing.assert_allclose(dens.grad.numpy(), w, rtol=0, atol=2e-3 * np.abs(w).max(),
                               err_msg="densify")
    assert np.abs(w).max() > 0


def _median_only_gradient(p):
    """The depth channel's gradient with v_median = 1 and nothing else."""
    xs = [_t(p[k]).requires_grad_() for k in ("m2", "M", "feats", "nrm", "op")]
    C, N = p["m2"].shape[:2]
    out = rasterize_to_pixels_2dgs(xs[0], xs[1].reshape(C, N, 9), *xs[2:], W, H,
                                   _t(p["radii"]), _t(p["d"]), 16384)
    out[4].sum().backward()
    return xs[2].grad[..., -1], out[4]


def test_median_gradient_lands_on_one_slot_per_pixel(projected):
    """With only v_median = 1, each pixel that has a median adds exactly 1 to
    its median surfel's depth channel and nothing elsewhere."""
    g_depth, median = _median_only_gradient(projected)
    n_med = int((median > 0).sum())
    assert n_med > 100
    assert float(g_depth.sum()) == n_med
    assert torch.equal(g_depth, torch.round(g_depth))


def test_chunk_resume_scene_follows_oracle():
    """A pixel stops for good at the surfel that saturates it.

    200 broad camera-facing surfels over one 16x16 tile, front to back:
    slots 0-99 green at opacity 0.05, slot 100 at 0.99 (it takes the centre
    pixel's T below 1e-4), slots 101+ red at 0.5.  The oracle stops the
    pixel at slot 100; the JAX Pallas kernel decides per 128-slot chunk and
    resumes it at slot 128 (ROADMAP Queue 3); the port follows the oracle.
    """
    N, S = 200, 16
    m2 = np.full((1, N, 2), 8.5, np.float32)
    M = np.tile(np.array([[48.0, 0, 40], [0, 48, 40], [0, 0, 5]], np.float32), (1, N, 1, 1))
    op = np.full((1, N), 0.05, np.float32)
    op[0, 100] = 0.99
    op[0, 101:] = 0.5
    feats = np.zeros((1, N, 4), np.float32)
    feats[0, :101, 1] = 1.0
    feats[0, 101:, 0] = 1.0
    d = np.linspace(1.0, 3.0, N, dtype=np.float32)[None]
    feats[..., 3] = d
    nrm = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (1, N, 1))
    radii = np.full((1, N, 2), 8, np.int32)
    jargs = tuple(map(jnp.asarray, (m2, M, feats, nrm, op)))
    ref = _oracle(*jargs, jnp.asarray(radii), jnp.asarray(d), S, S)
    got = rasterize_to_pixels_2dgs(_t(m2), _t(M).reshape(1, N, 9), _t(feats), _t(nrm), _t(op),
                                   S, S, _t(radii), _t(d), 1024)
    for name, g, r in zip(IMAGES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-4, err_msg=name)
    assert float(ref[0][0, 8, 8, 0]) == 0.0 and float(got[0][0, 8, 8, 0]) == 0.0
    pal = j_r2d(jargs[0], jargs[1].reshape(1, N, 9), *jargs[2:], S, S, jnp.asarray(radii),
                jnp.asarray(d), 1024)
    assert float(pal[0][0, 8, 8, 0]) > 1e-3  # red behind the saturating surfel


@pytest.mark.parametrize("depth_mode", ["expected", "median"])
def test_rasterization_2dgs_matches_jax(depth_mode):
    """All seven outputs of rasterization_2dgs, RGB+ED, against the JAX
    function (its Pallas path).  The normals from depth are unit vectors of
    differences of neighbouring points, which cancel where the depth is
    flat: held to 99.5% of entries within 2e-4 and all within 5e-2."""
    s = surfel_scene()
    keys = ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")
    want = j_rast2d(*(jnp.asarray(s[k]) for k in keys), W, H, render_mode="RGB+ED",
                    depth_mode=depth_mode)
    got = rasterization_2dgs(*(torch.from_numpy(s[k]) for k in keys), W, H, render_mode="RGB+ED",
                             depth_mode=depth_mode)
    names = ("render", "alphas", "normals", "normals_from_depth", "distort", "median")
    for name, g, w in zip(names, got[:6], want[:6]):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        diff = np.abs(g.numpy() - w)
        if name == "normals_from_depth":
            assert (diff > 2e-4).mean() < 5e-3 and diff.max() < 5e-2, name
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4, err_msg=name)
    meta, jmeta = got[6], want[6]
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(jmeta["radii"]))
    for k in ("means2d", "depths", "ray_transforms", "normals"):
        w = np.asarray(jmeta[k])
        np.testing.assert_allclose(meta[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    assert int(meta["n_isects"]) == int(jmeta["n_isects"])
    assert meta["gradient_2dgs"] is None and set(meta) == set(jmeta)


def test_render_modes_and_bad_arguments():
    s = surfel_scene(N=60)
    keys = ("means", "quats", "scales", "opacities", "colors", "viewmats", "Ks")
    args = [torch.from_numpy(s[k]) for k in keys]
    for mode, X in (("RGB", 3), ("D", 1), ("ED", 1), ("RGB+D", 4)):
        out = rasterization_2dgs(*args, W, H, render_mode=mode)
        assert out[0].shape == (2, H, W, X), mode
        assert (out[3] is None) == (mode != "RGB+D"), mode
    with pytest.raises(ValueError, match="render_mode"):
        rasterization_2dgs(*args, W, H, render_mode="RGB-d")
    with pytest.raises(ValueError, match="tile_size"):
        rasterization_2dgs(*args, W, H, tile_size=8)
    fields = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="bounds"):
        t2k.rasterize2d_fwd(fields, torch.zeros(3, dtype=torch.int32), 1, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="pair_counts"):
        t2k.rasterize2d_fwd(fields, torch.zeros(2, dtype=torch.int32), 1, 1, 1, 16, 16,
                            pair_counts=torch.zeros(1, dtype=torch.int32))


def test_plain_composite_on_a_tile_subset_and_any_batching(projected):
    """The plain forward gives the same bits for a subset of tiles (their
    pixels) and whatever its batch budget; the plain backward the same
    gradients on those tiles' slots, to the order of its vectorized sums."""
    p = projected
    C, N = p["m2"].shape[:2]
    E = C * N
    tw, th = -(-W // TS), -(-H // TS)
    from gsplat_tpu_torch.ops import rasterize as tr

    plan = tr.make_emission_plan(_t(p["m2"]), _t(p["radii"]), TS, tw, th, 8192)
    table = torch.cat([_t(p["m2"]).reshape(E, 2), _t(p["M"]).reshape(E, 9),
                       _t(p["op"]).reshape(E, 1), _t(p["feats"]).reshape(E, 4),
                       _t(p["nrm"]).reshape(E, 3)], 1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0)
    fields, bounds, _, _ = tr.expand_sort_align(table, _t(p["d"]).reshape(E), plan, 8192, tw, th, C)
    args = (fields, bounds, C, tw, th, W, H)
    full = t2k.rasterize2d_fwd_plain(*args)
    tiles = torch.tensor([7, 2, 19])
    part = t2k.rasterize2d_fwd_plain(*args, tiles=tiles, budget=1 << 14)
    tile_of = ((torch.arange(C)[:, None, None] * tw * th + (torch.arange(H)[None, :, None] // TS) * tw
                + torch.arange(W)[None, None, :] // TS))
    on = torch.isin(tile_of, tiles)
    for a, b in zip(full, part):
        assert torch.equal(a[on], b[on])
    assert not part[0][~on].any() and not part[1][~on].any()
    assert bool((part[2][~on] == -1).all())
    g = torch.Generator().manual_seed(0)
    v_pix, v_t = torch.randn(full[0].shape, generator=g), torch.randn(full[1].shape, generator=g)
    bargs = (*args, v_pix, v_t, *full)
    v_full, n_full = t2k.rasterize2d_bwd_plain(*bargs)
    v_part, n_part = t2k.rasterize2d_bwd_plain(*bargs, tiles=tiles, budget=1 << 14)
    slots = torch.cat([torch.arange(int(bounds[t]), int(bounds[t + 1])) for t in tiles.tolist()])
    np.testing.assert_allclose(v_part[:, slots].numpy(), v_full[:, slots].numpy(), rtol=1e-5,
                               atol=1e-6 * float(v_full.abs().max()))
    assert 0 < n_part < n_full
    rest = torch.ones(fields.shape[1], dtype=torch.bool)
    rest[slots] = False
    assert not v_part[:, rest].any()
