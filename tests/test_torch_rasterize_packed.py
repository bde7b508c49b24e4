"""Port parity: rasterize_to_pixels_packed against the JAX function.

Packed (image, gaussian) rows with their image ids, rows past `n_live`
(with live radii, which must not render), zero-radius rows carrying NaN
conics, several images, masks and backgrounds, absgrad, and a capacity
small enough to overflow.  The same numpy rows go through the JAX function
(Pallas in interpret mode on the CPU) and through the port on the CPU
(the kernels' plain versions).  Images in the JAX suite's band (95% of
pixels within 3e-5, all within 2e-4: the Pallas kernel's transmittance is
exp(cumsum(log(1 - alpha))), tests/test_rasterize_pallas.py:67-81);
n_isects and isect_overflow equal; gradients in the caller's row layout
within 3e-4 of each tensor's largest entry (the JAX suite's gradient band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import rasterize as jr
from gsplat_tpu_torch.ops import rasterize as tr

W, H = 40, 35  # deliberately not tile multiples
I, E, N_LIVE, D = 3, 330, 290, 3


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-5, 45, (E, 2)).astype(np.float32)
    L = rng.standard_normal((E, 2, 2)).astype(np.float32) * 0.4
    cov = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(2, dtype=np.float32)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1).astype(np.float32)
    colors = rng.random((E, D)).astype(np.float32)
    opacities = np.clip(rng.random(E) * 1.2, 0, 1).astype(np.float32)
    radii = np.full((E, 2), 5, np.int32)
    radii[::7] = 0
    conics[::7] = np.nan  # culled rows may carry NaN; they must not leak
    depths = (rng.random(E) * 5 + 0.1).astype(np.float32)
    depths[::11] = depths[1]  # ties keep row order
    image_ids = rng.integers(0, I, E).astype(np.int32)
    return dict(means2d=means2d, conics=conics, colors=colors, opacities=opacities,
                radii=radii, depths=depths, image_ids=image_ids)


def _extras(seed, tile):
    rng = np.random.default_rng(seed + 100)
    tw, th = -(-W // tile), -(-H // tile)
    masks = rng.random((I, th, tw)) > 0.3
    backgrounds = rng.random((I, D)).astype(np.float32)
    return masks, backgrounds


def _band_close(a, b, name, strict=3e-5, frac=0.05, hard=2e-4):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert float((diff > strict).mean()) < frac, (name, float((diff > strict).mean()))
    assert float(diff.max()) < hard, (name, float(diff.max()))


DIFF = ("means2d", "conics", "colors", "opacities")


def _jax(s, cap, tile, masks, bgs, absgrad, v):
    rest = dict(radii=jnp.asarray(s["radii"]), depths=jnp.asarray(s["depths"]),
                image_ids=jnp.asarray(s["image_ids"]), n_live=jnp.asarray(np.int32(N_LIVE)))

    def f(m2, cn, cl, op, m2abs):
        img, alpha, aux = jr.rasterize_to_pixels_packed(
            m2, cn, cl, op, rest["radii"], rest["depths"], rest["image_ids"], rest["n_live"],
            I, W, H, cap, backgrounds=None if bgs is None else jnp.asarray(bgs),
            masks=None if masks is None else jnp.asarray(masks), tile_size=tile,
            absgrad=absgrad, means2d_abs=m2abs, pack_payload=False, pack_grads=False)
        loss = jnp.sum(img * v[0]) + jnp.sum(alpha * v[1])
        return loss, (img, alpha, aux)

    args = [jnp.asarray(s[k]) for k in DIFF] + [jnp.zeros((E, 2), jnp.float32)]
    grads, (img, alpha, aux) = jax.grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return img, alpha, aux, grads


def _port(s, cap, tile, masks, bgs, absgrad, v):
    leaves = [torch.from_numpy(s[k]).requires_grad_() for k in DIFF]
    m2abs = torch.zeros((E, 2), requires_grad=True)
    img, alpha, aux = tr.rasterize_to_pixels_packed(
        *leaves, torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"]),
        torch.from_numpy(s["image_ids"]), torch.tensor(N_LIVE, dtype=torch.int32), I, W, H, cap,
        backgrounds=None if bgs is None else torch.from_numpy(bgs),
        masks=None if masks is None else torch.from_numpy(masks), tile_size=tile,
        absgrad=absgrad, means2d_abs=m2abs if absgrad else None)
    loss = (img * torch.from_numpy(v[0])).sum() + (alpha * torch.from_numpy(v[1])).sum()
    loss.backward()
    grads = [x.grad for x in leaves] + [m2abs.grad]
    return img.detach(), alpha.detach(), aux, grads


def _cotangents(seed):
    rng = np.random.default_rng(seed + 200)
    return (rng.standard_normal((I, H, W, D)).astype(np.float32),
            rng.standard_normal((I, H, W, 1)).astype(np.float32))


@pytest.mark.parametrize("tile,with_extras,absgrad", [(16, False, False), (8, True, True)],
                         ids=["tile16", "tile8-masks-backgrounds-absgrad"])
def test_packed_rows_match_jax_in_value_and_gradient(tile, with_extras, absgrad):
    s = _rows(seed=tile)
    masks, bgs = _extras(tile, tile) if with_extras else (None, None)
    v = _cotangents(tile)
    j_img, j_alpha, j_aux, j_grads = _jax(s, 8192, tile, masks, bgs, absgrad, v)
    t_img, t_alpha, t_aux, t_grads = _port(s, 8192, tile, masks, bgs, absgrad, v)
    _band_close(t_img.numpy(), j_img, "colors")
    _band_close(t_alpha.numpy(), j_alpha, "alphas")
    assert int(t_aux["n_isects"]) == int(j_aux["n_isects"]) > 0
    assert bool(t_aux["isect_overflow"]) == bool(j_aux["isect_overflow"]) is False
    names = DIFF + (("means2d_abs",) if absgrad else ())
    for name, g, w in zip(names, t_grads, j_grads):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, atol=3e-4 * scale, rtol=0, err_msg=name)
    # rows past n_live and culled rows take no gradient, in both packages
    dead = np.arange(E) >= N_LIVE
    dead[::7] = True
    assert not t_grads[0].numpy()[dead].any() and not np.asarray(j_grads[0])[dead].any()


def test_packed_capacity_overflow_matches_jax():
    """A capacity that truncates: the same n_isects, the overflow flag, and
    the same truncated image."""
    s = _rows(seed=5)
    s["radii"] = np.where(s["radii"] > 0, 40, 0).astype(np.int32)  # wide footprints
    s["conics"] = s["conics"] * np.float32(0.01)
    j_img, j_alpha, j_aux = jr.rasterize_to_pixels_packed(
        *(jnp.asarray(s[k]) for k in DIFF + ("radii", "depths", "image_ids")),
        jnp.asarray(np.int32(N_LIVE)), I, W, H, 512, tile_size=8, pack_payload=False,
        pack_grads=False)
    with torch.no_grad():
        t_img, t_alpha, t_aux = tr.rasterize_to_pixels_packed(
            *(torch.from_numpy(s[k]) for k in DIFF + ("radii", "depths", "image_ids")),
            N_LIVE, I, W, H, 512, tile_size=8)
    assert int(t_aux["n_isects"]) == int(j_aux["n_isects"]) > 512
    assert bool(t_aux["isect_overflow"]) and bool(j_aux["isect_overflow"])
    _band_close(t_img.numpy(), j_img, "colors")
    _band_close(t_alpha.numpy(), j_alpha, "alphas")


def test_packed_rows_equal_the_unpacked_op_on_the_same_splats():
    """Rows of every (image, gaussian) pair in image-major order render what
    rasterize_to_pixels renders of the [I, N] arrays, bit for bit."""
    s = _rows(seed=9)
    N = E // I
    im = np.repeat(np.arange(I, dtype=np.int32), N)
    t = lambda k: torch.from_numpy(s[k][: I * N])
    with torch.no_grad():
        p_img, p_alpha, p_aux = tr.rasterize_to_pixels_packed(
            *(t(k) for k in DIFF + ("radii", "depths")), torch.from_numpy(im), I * N, I, W, H,
            8192)
        u_img, u_alpha, u_aux = tr.rasterize_to_pixels(
            *(t(k).reshape((I, N) + s[k].shape[1:]) for k in DIFF), W, H,
            t("radii").reshape(I, N, 2), t("depths").reshape(I, N), 8192)
    assert torch.equal(p_img, u_img) and torch.equal(p_alpha, u_alpha)
    assert int(p_aux["n_isects"]) == int(u_aux["n_isects"])
