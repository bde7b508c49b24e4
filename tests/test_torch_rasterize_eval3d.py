"""Port parity: rasterize_to_pixels_eval3d (the plain versions of K7a and K7b
on the CPU) against gsplat_tpu's eval3d op (Pallas in interpret mode) and
its oracle (rasterize_to_pixels_eval3d_ref through isect_tiles), forward
and backward, on the scene of tests/test_rasterize_eval3d.py; then
rasterization(with_ut=True, with_eval3d=True) end to end against the JAX
package, on a distorted pinhole and on the lidar.

Tolerances are the JAX suite's own (tests/test_rasterize_eval3d.py:89-171):
images within 2e-5 (5e-5 with the hit distance), gradients within 4e-4 of
each input's largest entry (5e-4 with the hit distance), ray gradients
included.  Two scenes hold the rules where the JAX op and its oracle part:
a pixel that saturates in its first 128-slot chunk stops for good (the
oracle; the Pallas kernel resumes it in the next chunk), and a ray with a
zero direction starts at T = 0 (the Pallas kernel; the oracle composites
it).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.projection import fully_fused_projection
from gsplat_tpu.ops.rasterize_eval3d import rasterize_to_pixels_eval3d as j_e3d
from gsplat_tpu.ops.rasterize_eval3d_ref import rasterize_to_pixels_eval3d_ref
from gsplat_tpu.rendering import rasterization as j_rast
from gsplat_tpu.sensors import generate_rays, make_camera
from gsplat_tpu.sensors import lidars as jl
from gsplat_tpu_torch import rasterization
from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as tk
from gsplat_tpu_torch.ops.math import quat_to_rotmat
from gsplat_tpu_torch.ops.rasterize import expand_sort_align, make_emission_plan
from gsplat_tpu_torch.ops.rasterize_eval3d import (
    iscl_rot_from_quat_scale,
    rasterize_to_pixels_eval3d,
)
from gsplat_tpu_torch.sensors import lidars as tl

W, H, TS = 40, 35, 16
ARGS = ("means", "quats", "scales", "colors", "opacities")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


def _projected(means, quats, scales, opacities, viewmats, Ks, rays):
    """The JAX projection's tiling inputs and the oracle's intersections."""
    I = viewmats.shape[0]
    radii, means2d, depths, _, _ = fully_fused_projection(
        jnp.asarray(means), None, jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(viewmats), jnp.asarray(Ks), W, H, opacities=jnp.asarray(opacities[0]))
    tw, th = -(-W // TS), -(-H // TS)
    isect = isect_tiles(means2d, radii, depths, TS, tw, th, capacity=4096)
    offsets = isect_offset_encode(isect.tile_keys, I, tw, th)
    return dict(rays=jnp.asarray(rays), radii=radii, means2d=means2d, depths=depths,
                isect=isect, offsets=offsets)


def _make_scene():
    rng = np.random.default_rng(3)
    I, N, D = 2, 120, 3
    means = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(2.0, 6.0, N)
    s = dict(means=means, quats=rng.normal(size=(N, 4)).astype(np.float32),
             scales=rng.uniform(0.05, 0.25, (N, 3)).astype(np.float32),
             opacities=np.clip(rng.random((I, N)) * 1.2, 0, 1).astype(np.float32),
             colors=rng.random((I, N, D)).astype(np.float32))
    vm = np.tile(np.eye(4, dtype=np.float32), (I, 1, 1))
    vm[1, :3, 3] = [0.05, -0.03, 0.1]
    Ks = np.zeros((I, 3, 3), np.float32)
    Ks[:, 0, 0] = Ks[:, 1, 1] = 30.0
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = W / 2, H / 2, 1.0
    cam = make_camera("pinhole", W, H, focal_lengths=jnp.asarray(Ks[:, [0, 1], [0, 1]]),
                      principal_points=jnp.asarray(Ks[:, :2, 2]))
    rays = np.asarray(generate_rays(cam, W, H, jnp.asarray(vm)))
    s.update(_projected(s["means"], s["quats"], s["scales"], s["opacities"], vm, Ks, rays))
    return s


@pytest.fixture(scope="module")
def scene():
    return _make_scene()


def _oracle(s, *a, rays=None, **kw):
    return rasterize_to_pixels_eval3d_ref(
        *a, s["rays"] if rays is None else rays, W, H, TS, s["offsets"], s["isect"].flatten_ids,
        s["isect"].n_isects, max_range=512, **kw)


def _pallas(s, *a, rays=None, **kw):
    return j_e3d(*a, s["rays"] if rays is None else rays, W, H, s["radii"], s["depths"],
                 s["means2d"], 4096, **kw)


def _port(s, *a, rays=None, **kw):
    return rasterize_to_pixels_eval3d(*a, _t(s["rays"]) if rays is None else rays, W, H,
                                      _t(s["radii"]), _t(s["depths"]), _t(s["means2d"]), 4096,
                                      **kw)


@pytest.mark.parametrize("hit_normals", [False, True], ids=["colors", "hit_normals"])
def test_forward_matches_oracle_and_pallas(scene, hit_normals):
    s = scene
    kw = dict(use_hit_distance=hit_normals, return_normals=hit_normals)
    args = [s[k] for k in ARGS]
    rc, ra, rn = _oracle(s, *map(jnp.asarray, args), **kw)
    pc, pa, pn, _ = _pallas(s, *map(jnp.asarray, args), **kw)
    c, a, n, aux = _port(s, *map(_t, args), **kw)
    assert not bool(aux["isect_overflow"]) and float(np.abs(np.asarray(rc)).max()) > 0.05
    tol = 5e-5 if hit_normals else 2e-5
    for got, ref, pal, what in ((c, rc, pc, "colors"), (a, ra, pa, "alphas"), (n, rn, pn, "normals")):
        if ref is None:
            assert got is None
            continue
        _close(got, ref, tol, what + " vs oracle")
        _close(got, pal, tol, what + " vs Pallas")
    if hit_normals:
        assert float(c[..., -1].abs().max()) > 0.1  # hit distances are present
    np.testing.assert_array_equal(aux["tiles_per_gauss"].numpy(),
                                  np.asarray(_pallas(s, *map(jnp.asarray, args), **kw)[3]["tiles_per_gauss"]))


@pytest.mark.parametrize("hit", [False, True], ids=["colors", "hit_distance"])
def test_gradients_match_oracle(scene, hit):
    """Every input's gradient, the rays' included, against jax.grad of the
    oracle; with the hit distance its channel carries a squared loss."""
    s = scene
    tgt = np.random.default_rng(4).random((2, H, W, 3)).astype(np.float32)
    kw = dict(use_hit_distance=hit, return_normals=hit)

    def loss(c, a, n, xp, conv):
        out = xp.sum((c - conv(tgt)) ** 2) + 0.3 * xp.sum(a)
        if hit:
            out = out + xp.sum(c[..., -1] ** 2) + xp.sum(n ** 2)
        return out

    def jloss(m, q, sc, col, op, r):
        return loss(*_oracle(s, m, q, sc, col, op, rays=r, **kw), jnp, jnp.asarray)

    jin = [jnp.asarray(s[k]) for k in ARGS] + [s["rays"]]
    want = jax.grad(jloss, argnums=tuple(range(6)))(*jin)
    xs = [_t(s[k]).requires_grad_() for k in ARGS] + [_t(s["rays"]).requires_grad_()]
    c, a, n, _ = _port(s, *xs[:5], rays=xs[5], **kw)
    loss(c, a, n, torch, torch.from_numpy).backward()
    tol = 5e-4 if hit else 4e-4
    for name, x, w in zip(ARGS + ("rays",), xs, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-4, name
        _close(x.grad, w, tol * max(float(np.abs(w).max()), 1.0), name)


def _slot_tables(s, hit, normals):
    """The sorted slot table, spans and rays the op hands to K7a and K7b."""
    I, N = s["colors"].shape[:2]
    E = I * N
    D = s["colors"].shape[-1]
    tw, th = -(-W // TS), -(-H // TS)
    cap = 4096 + 512
    plan = make_emission_plan(_t(s["means2d"]), _t(s["radii"]), TS, tw, th, cap)
    M = iscl_rot_from_quat_scale(_t(s["quats"]), _t(s["scales"])).reshape(N, 9)
    rows = [_t(s["means"]), M, _t(s["opacities"][0])[:, None]]
    if hit:
        rows.append(_t(s["scales"]))
    rows.append(_t(s["colors"][0]))
    if normals:
        rows.append(quat_to_rotmat(_t(s["quats"]))[:, :, 2])
    table = torch.cat(rows, 1).repeat(I, 1)
    table = torch.where((plan.cnt > 0)[:, None], table, 0.0).t().contiguous()
    depth = torch.where(plan.cnt > 0, _t(s["depths"]).reshape(E), 0.0)
    fields, bounds, _, _ = expand_sort_align(table, depth, plan, cap, tw, th, I)
    return fields, bounds, _t(s["rays"]).contiguous(), (I, tw, th, W, H, hit, normals), D


@pytest.mark.parametrize("hit_normals", [False, True], ids=["colors", "hit_normals"])
def test_plain_kernels_on_a_subset_of_tiles(scene, hit_normals):
    """The plain versions restricted to some tiles (as the card's check runs
    them at 4k) give those tiles' pixels, and their slots' and rays'
    gradients, as a full run does; the wrappers refuse the card-only counts
    on the CPU."""
    fields, bounds, rays, geo, D = _slot_tables(scene, hit_normals, hit_normals)
    out, t_fin = tk.rasterize_eval3d_fwd(fields, bounds, rays, *geo)
    tiles = torch.tensor([1, 4, 6], dtype=torch.int64)
    part = tk.rasterize_eval3d_fwd_plain(fields, bounds, rays, *geo, tiles=tiles, budget=1 << 12)
    I, tw, th = geo[:3]
    tile_of = (torch.arange(I)[:, None, None] * (tw * th) + (torch.arange(H)[None, :, None] // TS) * tw
               + torch.arange(W)[None, None, :] // TS)
    on = torch.isin(tile_of, tiles)
    # PyTorch's CPU exp may round the vector body and the tail of a tensor
    # apart, so other batches can differ by an ulp: the images' band, 2e-5
    _close(part[0][on], out[on], 2e-5)
    _close(part[1][on], t_fin[on], 2e-5)
    g = torch.Generator().manual_seed(0)
    v_pix, v_t = torch.randn(out.shape, generator=g), torch.randn(t_fin.shape, generator=g)
    v_slot, v_rays = tk.rasterize_eval3d_bwd(fields, bounds, rays, *geo, v_pix, v_t, out, t_fin)
    sub, sub_rays, n_live = tk.rasterize_eval3d_bwd_plain(fields, bounds, rays, *geo, v_pix, v_t,
                                                          out, t_fin, tiles=tiles, budget=1 << 12)
    sel = torch.cat([torch.arange(int(bounds[t]), int(bounds[t + 1])) for t in tiles.tolist()])
    # another batching pads the spans to other lengths, which reorders the
    # sums: 1e-5 of each row's largest entry
    assert n_live > 0
    for got, want in zip(sub[:, sel], v_slot[:, sel]):
        _close(got, want, 1e-5 * max(float(want.abs().max()), 1e-30))
    _close(sub_rays[on], v_rays[on], 1e-5 * float(v_rays.abs().max()))
    assert bool((sub_rays[~on] == 0).all())
    if hit_normals:  # the input hit channel's row gets exactly nothing
        assert bool((v_slot[16 + D - 1] == 0).all())
    with pytest.raises(ValueError, match="CUDA kernel only"):
        tk.rasterize_eval3d_fwd(fields, bounds, rays, *geo,
                                pair_counts=torch.zeros(bounds.shape[0] - 1, dtype=torch.int32))


def test_a_pixel_that_saturates_stops_for_good():
    """Gaussians stacked on the optical axis: the centre pixels saturate
    within the first 128 slots of their tile, and 24 gaussians behind them
    with large colours follow.  The port stops those pixels for good, as the
    oracle does; the Pallas kernel resumes them in the next chunk and adds
    part of those colours."""
    n_front, n_back = 128, 24
    N = n_front + n_back
    means = np.zeros((N, 3), np.float32)
    means[:, 2] = 3.0 + 0.01 * np.arange(N)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (N, 1))
    scales = np.full((N, 3), 0.6, np.float32)
    opac = np.full((1, N), 0.1, np.float32)
    opac[0, n_front:] = 0.02
    colors = np.full((1, N, 1), 0.5, np.float32)
    colors[0, n_front:] = 1000.0
    vm = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]], np.float32)
    cam = make_camera("pinhole", W, H, focal_lengths=jnp.asarray([[30.0, 30.0]]),
                      principal_points=jnp.asarray([[W / 2, H / 2]]))
    rays = np.asarray(generate_rays(cam, W, H, jnp.asarray(vm)))
    s = _projected(means, quats, scales, opac, vm, Ks, rays)
    args = (means, quats, scales, colors, opac)
    rc, ra, _ = _oracle(s, *map(jnp.asarray, args))
    pc, _, _, _ = _pallas(s, *map(jnp.asarray, args))
    c, a, _, _ = _port(s, *map(_t, args))
    assert float(np.abs(np.asarray(pc) - np.asarray(rc)).max()) > 1e-3  # Pallas resumes
    _close(c, rc, 2e-5, "colors vs oracle")
    _close(a, ra, 2e-5, "alphas vs oracle")


def test_a_zero_ray_starts_at_zero_transmittance(scene):
    """One ray inside the image with a zero direction: as in the Pallas
    kernel its pixel composites nothing and keeps T = 0 (so its alpha reads
    1); every other pixel is unchanged.  The oracle composites it."""
    s = scene
    rays = np.array(s["rays"])
    rays[0, 17, 20, 3:] = 0.0
    args = [s[k] for k in ARGS]
    pc, pa, _, _ = _pallas(s, *map(jnp.asarray, args), rays=jnp.asarray(rays))
    c, a, _, _ = _port(s, *map(_t, args), rays=_t(rays))
    rc, ra, _ = _oracle(s, *map(jnp.asarray, args), rays=jnp.asarray(rays))
    assert float(c[0, 17, 20].abs().max()) == 0.0 and float(a[0, 17, 20, 0]) == 1.0
    _close(c, pc, 2e-5, "colors vs Pallas")
    _close(a, pa, 2e-5, "alphas vs Pallas")
    assert float(np.asarray(ra)[0, 17, 20, 0]) < 1.0  # the oracle's rule differs there


def _e2e_scene():
    rng = np.random.default_rng(7)
    N = 160
    means = np.c_[rng.uniform(-1, 1, (N, 2)), rng.uniform(2, 5, N)].astype(np.float32)
    return dict(means=means, quats=rng.normal(size=(N, 4)).astype(np.float32),
                scales=rng.uniform(0.05, 0.2, (N, 3)).astype(np.float32),
                opacities=rng.uniform(0.4, 1, N).astype(np.float32),
                colors=rng.uniform(0, 1, (N, 3)).astype(np.float32))


def _lidar(mod, **kw):
    el = np.linspace(0.35, -0.35, 24).astype(np.float32)
    az = np.linspace(math.radians(50), math.radians(-50), 40).astype(np.float32)
    return mod.make_lidar(el, az, (0.001 * np.sin(np.arange(24))).astype(np.float32), **kw)


@pytest.mark.parametrize("case", ["opencv_RGB-Ed", "lidar_RGB-d"])
def test_rasterization_eval3d_end_to_end(case):
    """rasterization(with_ut=True, with_eval3d=True): the image, alphas and
    normals, and the gradients of means, quats, scales, opacities and
    colours, against the JAX package."""
    s = _e2e_scene()
    lidar = case.startswith("lidar")
    mode = case.split("_")[1]
    if lidar:  # in front of the lidar, which looks along +x
        s["means"] = s["means"][:, [2, 0, 1]].copy()
        s["colors"] = s["colors"][:, :1].copy()
    vm = np.eye(4, dtype=np.float32)[None]
    Ks = np.array([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]], np.float32)
    rad = np.array([[0.03, -0.01, 0.0]], np.float32)
    rng = np.random.default_rng(8)

    def kw(jax_side):
        conv = jnp.asarray if jax_side else _t
        if lidar:
            return dict(camera_model="lidar", global_z_order=False,
                        lidar_coeffs=_lidar(jl) if jax_side else _lidar(tl, device="cpu"))
        return dict(radial_coeffs=conv(rad), return_normals=True)

    w, h = (40, 24) if lidar else (W, H)
    tgt = rng.uniform(0, 1, (1, h, w, s["colors"].shape[1] + 1)).astype(np.float32)

    def loss(img, alpha, nrm, xp, conv):
        out = xp.sum((img - conv(tgt)) ** 2) + 0.3 * xp.sum(alpha)
        return out if nrm is None else out + xp.sum(nrm ** 2)

    def jloss(*a):
        img, alpha, meta = j_rast(*a, jnp.asarray(vm), jnp.asarray(Ks), W, H, with_ut=True,
                                  with_eval3d=True, render_mode=mode, **kw(True))
        return loss(img, alpha, meta["render_normals"], jnp, jnp.asarray), (img, alpha, meta)

    jin = [jnp.asarray(s[k]) for k in ("means", "quats", "scales", "opacities", "colors")]
    (_, (jimg, jal, jmeta)), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                                      has_aux=True)(*jin)
    xs = [_t(s[k]).requires_grad_() for k in ("means", "quats", "scales", "opacities", "colors")]
    img, alpha, meta = rasterization(*xs, _t(vm), _t(Ks), W, H, with_ut=True, with_eval3d=True,
                                     render_mode=mode, **kw(False))
    loss(img, alpha, meta["render_normals"], torch, torch.from_numpy).backward()
    assert img.shape == (1, h, w, tgt.shape[-1]) and not bool(meta["isect_overflow"])
    assert float(alpha.detach().max()) > 0.5 and meta["rays"].shape == (1, h, w, 6)
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(jmeta["radii"]))
    _close(img, jimg, 5e-5 * max(1.0, float(np.abs(np.asarray(jimg)).max())), "image")
    _close(alpha, jal, 2e-5, "alphas")
    if not lidar:
        _close(meta["render_normals"], jmeta["render_normals"], 2e-5, "normals")
    for name, x, g in zip(("means", "quats", "scales", "opacities", "colors"), xs, jg):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        _close(x.grad, g, 5e-4 * max(float(np.abs(g).max()), 1.0), name)
