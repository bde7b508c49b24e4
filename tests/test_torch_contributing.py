"""Port parity: the contributing-gaussian ops, rasterize_to_indices_in_range
(3DGS and 2DGS) with accumulate, and sparse rasterization, against
gsplat_tpu/ops/contributing.py and rasterize_sparse.py and against the
port's own dense oracle, on the JAX suite's scene
(tests/test_contributing.py:20-50).

Exactness: counts, ids and the index lists equal the JAX ones exactly on
this scene, and the top-k selection too (a stable descending sort, ties to
the front slot, as jax.lax.top_k).  Zero flipped pixels are allowed, and
none is expected only because no (1 - alpha) product lands within an ulp of
the 1e-4 cutoff here: the port takes the serial float32 product of the
kernels, XLA's CPU cumprod a blocked scan, and torch's exp and XLA's
differ by an ulp on about a tenth of inputs, so a larger scene may flip a
pixel's count by one.  Weights and alphas within 1e-6; accumulate within
2e-5 of JAX (the drift of its global log-space cumsum on this list) and
2e-6 of the oracle; sparse images within 1e-6 of JAX and of the dense
oracle at those pixels, sparse gradients within 1e-5 of jax.grad and equal
bit for bit from run to run (K5 in a fixed order, no atomics).

`test_accumulate_drift_of_the_reference`: on 2^22 entries in 16,384 rays
of 256 slots the JAX function's per-ray alphas drift more than 1e-3 from
float64 per-ray products; the port's stay within 1e-5 (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import contributing as jc
from gsplat_tpu.ops import rasterize_sparse as jsp
from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu_torch.ops import contributing as tc
from gsplat_tpu_torch.ops import rasterize_sparse as tsp
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_to_pixels_ref as t_ref

W, H, TS = 40, 35, 16
MAX_RANGE = 512
TW, TH = -(-W // TS), -(-H // TS)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    I, N, D = 2, 150, 3
    means2d = rng.uniform(-5, 45, (I, N, 2)).astype(np.float32)
    L = rng.standard_normal((I, N, 2, 2)).astype(np.float32) * 0.4
    cov = L @ L.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    colors = rng.random((I, N, D)).astype(np.float32)
    opacities = np.clip(rng.random((I, N)) * 1.2, 0, 1).astype(np.float32)
    radii = np.full((I, N, 2), 5, np.int32)
    radii[:, ::7] = 0
    depths = (rng.random((I, N)) * 5 + 0.1).astype(np.float32)
    isect = isect_tiles(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), TS, TW,
                        TH, capacity=2048)
    P = 300
    pixels = np.stack([rng.integers(0, H, P), rng.integers(0, W, P)], -1).astype(np.int32)
    s = dict(means2d=means2d, conics=conics, colors=colors, opacities=opacities,
             offsets=np.asarray(isect_offset_encode(isect.tile_keys, I, TW, TH)),
             flatten_ids=np.asarray(isect.flatten_ids), n_isects=np.asarray(isect.n_isects),
             pixels=pixels, image_ids=rng.integers(0, I, P).astype(np.int32),
             bg=rng.random((I, D)).astype(np.float32))
    return {"j": {k: jnp.asarray(v) for k, v in s.items()},
            "t": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in s.items()}}


def _geom(s):
    return s["means2d"], s["conics"], s["opacities"], s["offsets"], s["flatten_ids"]


def _eq(a, b):
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _close(a, b, tol):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=tol)


def test_counts_ids_and_top_match_jax(scene):
    j, t = scene["j"], scene["t"]
    cj, aj = jc.rasterize_num_contributing_gaussians(*_geom(j), W, H, TS, j["n_isects"], MAX_RANGE)
    ct, at = tc.rasterize_num_contributing_gaussians(*_geom(t), W, H, TS, t["n_isects"], MAX_RANGE)
    _eq(cj, ct)
    _close(aj, at, 1e-6)
    K = int(ct.max())
    assert K > 3
    ij, wj = jc.rasterize_contributing_gaussian_ids(*_geom(j), W, H, TS, j["n_isects"],
                                                    MAX_RANGE, K)
    it, wt = tc.rasterize_contributing_gaussian_ids(*_geom(t), W, H, TS, t["n_isects"],
                                                    MAX_RANGE, K)
    _eq(ij, it)
    _close(wj, wt, 1e-6)
    for k in (4, K + 3):
        ij, wj = jc.rasterize_top_contributing_gaussian_ids(*_geom(j), W, H, TS, j["n_isects"],
                                                            MAX_RANGE, k)
        it, wt = tc.rasterize_top_contributing_gaussian_ids(*_geom(t), W, H, TS, t["n_isects"],
                                                            MAX_RANGE, k)
        _eq(ij, it)
        _close(wj, wt, 1e-6)


def test_counts_and_ids_against_the_port_oracle(scene):
    t = scene["t"]
    counts, alphas = tc.rasterize_num_contributing_gaussians(*_geom(t), W, H, TS, t["n_isects"],
                                                             MAX_RANGE)
    ref_c, ref_a = t_ref(t["means2d"], t["conics"], t["colors"], t["opacities"], W, H, TS,
                         t["offsets"], t["flatten_ids"], t["n_isects"], MAX_RANGE)
    assert torch.equal(alphas, ref_a[..., 0])
    ids, w = tc.rasterize_contributing_gaussian_ids(*_geom(t), W, H, TS, t["n_isects"],
                                                    MAX_RANGE, int(counts.max()))
    assert torch.equal((ids >= 0).sum(-1).to(torch.int32), counts)
    torch.testing.assert_close(w.sum(-1), alphas, rtol=0, atol=1e-6)
    cl = t["colors"][torch.arange(2)[:, None, None, None], ids.clamp(min=0).long()]
    torch.testing.assert_close((w[..., None] * cl).sum(-2), ref_c, rtol=0, atol=1e-6)
    # the top-k: the k largest weights of the full list, a subset of its ids
    k = 4
    top_ids, top_w = tc.rasterize_top_contributing_gaussian_ids(
        *_geom(t), W, H, TS, t["n_isects"], MAX_RANGE, k)
    want = torch.sort(w, dim=-1, descending=True).values[..., :k]
    torch.testing.assert_close(torch.sort(top_w, dim=-1, descending=True).values, want,
                               rtol=0, atol=0)
    member = (top_ids[..., :, None] == ids[..., None, :]).any(-1) | (top_ids < 0)
    assert bool(member.all())


def test_indices_in_range_and_accumulate_match_jax_and_the_oracle(scene):
    j, t = scene["j"], scene["t"]
    geo_j = (j["means2d"], j["conics"], j["opacities"], W, H, TS, j["offsets"], j["flatten_ids"],
             j["n_isects"])
    geo_t = (t["means2d"], t["conics"], t["opacities"], W, H, TS, t["offsets"], t["flatten_ids"],
             t["n_isects"])
    render_j, alphas_j = jnp.zeros((2, H, W, 3)), jnp.zeros((2, H, W, 1))
    render_t, alphas_t = torch.zeros((2, H, W, 3)), torch.zeros((2, H, W, 1))
    for step in range(2):
        trans_j, trans_t = 1.0 - alphas_j[..., 0], 1.0 - alphas_t[..., 0]
        lj = jc.rasterize_to_indices_in_range(step, step + 1, trans_j, *geo_j)
        lt = tc.rasterize_to_indices_in_range(step, step + 1, trans_t, *geo_t)
        for a, b in zip(lj, lt):
            _eq(a, b)
        rj, aj = jc.accumulate(j["means2d"], j["conics"], j["opacities"], j["colors"], *lj, W, H)
        rt, at = tc.accumulate(t["means2d"], t["conics"], t["opacities"], t["colors"], *lt, W, H)
        _close(rj, rt, 2e-5)
        _close(aj, at, 2e-5)
        render_j = render_j + rj * trans_j[..., None]
        alphas_j = alphas_j + aj * trans_j[..., None]
        render_t = render_t + rt * trans_t[..., None]
        alphas_t = alphas_t + at * trans_t[..., None]
    ref_c, ref_a = t_ref(t["means2d"], t["conics"], t["colors"], t["opacities"], W, H, TS,
                         t["offsets"], t["flatten_ids"], t["n_isects"], MAX_RANGE)
    torch.testing.assert_close(render_t, ref_c, rtol=0, atol=2e-6)
    torch.testing.assert_close(alphas_t, ref_a, rtol=0, atol=2e-6)


def test_accumulate_splits_runs_across_chunks(scene, monkeypatch):
    """A chunk of 5000 entries cuts rays of 256 entries in the middle: the
    transmittance carries over and the result is the one-chunk result."""
    t = scene["t"]
    lt = tc.rasterize_to_indices_in_range(0, 1, torch.ones(2, H, W), t["means2d"], t["conics"],
                                          t["opacities"], W, H, TS, t["offsets"],
                                          t["flatten_ids"], t["n_isects"])
    one = tc.accumulate(t["means2d"], t["conics"], t["opacities"], t["colors"], *lt, W, H)
    monkeypatch.setattr(tc, "_ACC_CHUNK", 5000)
    many = tc.accumulate(t["means2d"], t["conics"], t["opacities"], t["colors"], *lt, W, H)
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_accumulate_drift_of_the_reference():
    """2^22 entries, 16,384 rays of 256; alpha_e = opacity_e (conics 0), from
    U[0, 0.05].  The per-ray composite alpha is sum_e alpha_e T_e, which
    float64 per-ray products give exactly enough to judge both."""
    rng = np.random.default_rng(14)
    n_rays, per = 16384, 256
    M = n_rays * per
    Wd = Hd = 128
    alpha = rng.uniform(0.0, 0.05, M).astype(np.float32)
    a64 = alpha.astype(np.float64).reshape(n_rays, per)
    t_excl = np.cumprod(np.concatenate([np.ones((n_rays, 1)), 1.0 - a64[:, :-1]], 1), 1)
    want = (a64 * t_excl).sum(1).reshape(1, Hd, Wd, 1)
    m2 = np.zeros((1, M, 2), np.float32)
    cn = np.zeros((1, M, 3), np.float32)
    cl = np.ones((1, M, 1), np.float32)
    ids = (np.arange(M, dtype=np.int32), np.repeat(np.arange(n_rays, dtype=np.int32), per),
           np.zeros(M, np.int32), np.ones(M, bool))
    _, a_jax = jax.jit(jc.accumulate, static_argnums=(8, 9))(
        *map(jnp.asarray, (m2, cn, alpha[None], cl) + ids), Wd, Hd)
    _, a_port = tc.accumulate(*map(torch.from_numpy, (m2, cn, alpha[None], cl) + ids), Wd, Hd)
    err_jax = float(np.abs(np.asarray(a_jax, np.float64) - want).max())
    err_port = float(np.abs(a_port.numpy().astype(np.float64) - want).max())
    print(f"accumulate on {M} entries: JAX {err_jax:.3g}, port {err_port:.3g}")
    assert err_jax > 1e-3, err_jax
    assert err_port < 1e-5, err_port


def test_indices_in_range_2dgs_matches_jax():
    rng = np.random.default_rng(8)
    I, N = 1, 60
    means2d = rng.uniform(0, 40, (I, N, 2)).astype(np.float32)
    M = np.zeros((I, N, 3, 3), np.float32)
    M[..., 0, 0] = M[..., 1, 1] = 0.2
    M[..., 2, 2] = 1.0
    M[..., 0, 2] = -0.2 * means2d[..., 0]
    M[..., 1, 2] = -0.2 * means2d[..., 1]
    opac = rng.uniform(0.5, 1, (I, N)).astype(np.float32)
    radii = np.full((I, N, 2), 6, np.int32)
    depths = rng.uniform(1, 5, (I, N)).astype(np.float32)
    isect = isect_tiles(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), TS, TW,
                        TH, capacity=2048)
    offsets = isect_offset_encode(isect.tile_keys, I, TW, TH)
    trans = rng.uniform(0.5, 1.0, (I, H, W)).astype(np.float32)
    args = (trans, means2d, M, opac, W, H, TS, offsets, isect.flatten_ids, isect.n_isects)
    want = jc.rasterize_to_indices_in_range_2dgs(
        0, 2, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = tc.rasterize_to_indices_in_range_2dgs(
        0, 2, *(torch.from_numpy(np.asarray(a).copy()) if not isinstance(a, int) else a
                for a in args))
    for a, b in zip(want, got):
        _eq(a, b)
    assert int(got[3].sum()) > 100


def _sparse_args(s, lib):
    return (s["means2d"], s["conics"], s["colors"], s["opacities"], s["pixels"], s["image_ids"],
            W, H, TS, s["offsets"], s["flatten_ids"], s["n_isects"], MAX_RANGE)


def test_sparse_forward_matches_jax_and_the_oracle(scene):
    j, t = scene["j"], scene["t"]
    cj, aj = jsp.rasterize_to_pixels_sparse(*_sparse_args(j, jnp), backgrounds=j["bg"])
    ct, at = tsp.rasterize_to_pixels_sparse(*_sparse_args(t, torch), backgrounds=t["bg"])
    _close(cj, ct, 1e-6)
    _close(aj, at, 1e-6)
    ref_c, ref_a = t_ref(t["means2d"], t["conics"], t["colors"], t["opacities"], W, H, TS,
                         t["offsets"], t["flatten_ids"], t["n_isects"], MAX_RANGE,
                         backgrounds=t["bg"])
    im, py, px = t["image_ids"].long(), t["pixels"][:, 0].long(), t["pixels"][:, 1].long()
    torch.testing.assert_close(ct, ref_c[im, py, px], rtol=0, atol=1e-6)
    torch.testing.assert_close(at, ref_a[im, py, px], rtol=0, atol=1e-6)


def _sparse_grads(t, v, bg=True):
    leaves = [t[k].clone().requires_grad_() for k in ("means2d", "conics", "colors", "opacities",
                                                       "bg")]
    s = dict(t, means2d=leaves[0], conics=leaves[1], colors=leaves[2], opacities=leaves[3])
    c, a = tsp.rasterize_to_pixels_sparse(*_sparse_args(s, torch),
                                          backgrounds=leaves[4] if bg else None)
    ((c * v[0]).sum() + (a * v[1]).sum()).backward()
    return [x.grad for x in leaves]


def test_sparse_backward_matches_jax_and_repeats_bit_for_bit(scene):
    j, t = scene["j"], scene["t"]
    rng = np.random.default_rng(2)
    v = (rng.standard_normal((300, 3)).astype(np.float32),
         rng.standard_normal((300, 1)).astype(np.float32))

    def loss(m2, cn, cl, op, bg):
        s = dict(j, means2d=m2, conics=cn, colors=cl, opacities=op)
        c, a = jsp.rasterize_to_pixels_sparse(*_sparse_args(s, jnp), backgrounds=bg)
        return (c * v[0]).sum() + (a * v[1]).sum()

    keys = ("means2d", "conics", "colors", "opacities", "bg")
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(j[k] for k in keys))
    vt = tuple(map(torch.from_numpy, v))
    got = _sparse_grads(t, vt)
    for name, a, b in zip(keys, want, got):
        a = np.asarray(a)
        assert float(np.abs(a).max()) > 0, name
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * max(1.0, np.abs(a).max()),
                                   err_msg=name)
    again = _sparse_grads(t, vt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sparse_contributing_variants_match_jax_and_the_dense_ops(scene):
    j, t = scene["j"], scene["t"]

    def call(lib, mod, name, s, *extra):
        return getattr(mod, name)(s["means2d"], s["conics"], s["opacities"], s["pixels"],
                                  s["image_ids"], W, H, TS, s["offsets"], s["flatten_ids"],
                                  s["n_isects"], MAX_RANGE, *extra)

    im, py, px = t["image_ids"].long(), t["pixels"][:, 0].long(), t["pixels"][:, 1].long()
    dense_c, dense_a = tc.rasterize_num_contributing_gaussians(*_geom(t), W, H, TS, t["n_isects"],
                                                               MAX_RANGE)
    cj, aj = call(jnp, jsp, "rasterize_num_contributing_gaussians_sparse", j)
    ct, at = call(torch, tsp, "rasterize_num_contributing_gaussians_sparse", t)
    _eq(cj, ct)
    _close(aj, at, 1e-6)
    assert torch.equal(ct, dense_c[im, py, px]) and torch.equal(at, dense_a[im, py, px])
    K = int(ct.max())
    for name, extra in (("rasterize_contributing_gaussian_ids_sparse", K),
                        ("rasterize_top_contributing_gaussian_ids_sparse", 4)):
        ij, wj = call(jnp, jsp, name, j, extra)
        it, wt = call(torch, tsp, name, t, extra)
        _eq(ij, it)
        _close(wj, wt, 1e-6)
    dense_ids, _ = tc.rasterize_contributing_gaussian_ids(*_geom(t), W, H, TS, t["n_isects"],
                                                          MAX_RANGE, K)
    it, _ = call(torch, tsp, "rasterize_contributing_gaussian_ids_sparse", t, K)
    assert torch.equal(it, dense_ids[im, py, px])


def test_indices_in_range_resumes_a_saturated_pixel_as_the_reference():
    """Tile 4 (16-slot batches), one tile: 16 gaussians of alpha 0.5, then 24
    of 0.05, on the pixels.  T would fall below 1e-4 at the 14th, so batch 0
    stops each pixel there and excludes it; batch 1 sees only the
    transmittance (1.2e-4) and takes its first slots again, in the port as
    in the JAX function and upstream gsplat.  The lists equal JAX's, and the
    composite exceeds the oracle's (which stops for good) by less than the
    oracle's final transmittance."""
    ts, n = 4, 40
    m2 = np.full((1, n, 2), 2.0, np.float32)
    cn = np.tile(np.array([1e-3, 0.0, 1e-3], np.float32), (1, n, 1))
    op = np.full((1, n), 0.05, np.float32)
    op[:, :16] = 0.5
    cl = np.random.default_rng(3).random((1, n, 3)).astype(np.float32)
    radii = np.full((1, n, 2), 1, np.int32)
    depths = np.arange(1, n + 1, dtype=np.float32)[None]
    isect = isect_tiles(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths), ts, 1, 1,
                        capacity=64)
    offsets = isect_offset_encode(isect.tile_keys, 1, 1, 1)
    T = lambda x: torch.from_numpy(np.asarray(x).copy())
    geo_j = (jnp.asarray(m2), jnp.asarray(cn), jnp.asarray(op), ts, ts, ts, offsets,
             isect.flatten_ids, isect.n_isects)
    geo_t = (T(m2), T(cn), T(op), ts, ts, ts, T(offsets), T(isect.flatten_ids),
             T(isect.n_isects))
    render, alphas = torch.zeros(1, ts, ts, 3), torch.zeros(1, ts, ts, 1)
    for step in range(3):
        trans = 1.0 - alphas[..., 0]
        lt = tc.rasterize_to_indices_in_range(step, step + 1, trans, *geo_t)
        lj = jc.rasterize_to_indices_in_range(step, step + 1, jnp.asarray(trans.numpy()), *geo_j)
        for a, b in zip(lj, lt):
            _eq(a, b)
        r, a = tc.accumulate(T(m2), T(cn), T(op), T(cl), *lt, ts, ts)
        render = render + r * trans[..., None]
        alphas = alphas + a * trans[..., None]
        if step == 1:
            assert int(lt[3].sum()) > 0  # the stopped pixels take slots again
    ref_c, ref_a = t_ref(T(m2), T(cn), T(cl), T(op), ts, ts, ts, T(offsets),
                         T(isect.flatten_ids), T(isect.n_isects), n)
    t_final = 1.0 - ref_a
    extra = alphas - ref_a
    assert bool((extra > 1e-6).all()) and bool((extra <= t_final + 1e-6).all())
