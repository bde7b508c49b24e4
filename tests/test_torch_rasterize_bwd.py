"""Port parity: gradients of rasterize_to_pixels vs the JAX package.

The same numpy inputs go through `jax.grad` of the JAX functions (the Pallas
path in interpret mode, and the jnp oracle `rasterize_to_pixels_ref`) and
through `.backward()` of the port on the CPU, where the kernel wrappers
(K2 rasterize_bwd, K5 segment_rowsum) take their plain versions.

Tolerance: `3e-4 * max(1, max|g|)` per tensor, the JAX suite's own gradient
tolerance (tests/test_rasterize_pallas.py:131-135).  Reason: the gradients
are float32 sums over a tile's pixels and a gaussian's slots, taken in
another order by each implementation, and the Pallas path rounds its
transmittance scan through split-bf16 matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import rasterize as jr
from gsplat_tpu.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu.ops.rasterize_ref import rasterize_to_pixels_ref
from gsplat_tpu_torch.ops import rasterize as tr

W, H = 40, 35  # deliberately not tile multiples
NAMES = ("means2d", "conics", "colors", "opacities")


def _scene(seed=0, I=2, N=150, D=3):
    """The scene of tests/test_rasterize_pallas.py:20-48."""
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
    depths = (rng.random((I, N)) * 5 + 0.1).astype(np.float32)
    return dict(means2d=means2d, conics=conics, colors=colors, opacities=opacities,
                radii=radii, depths=depths)


def _target(shape, seed=2):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _loss(c, a, tgt):
    return ((c - tgt) ** 2).sum() + 0.3 * a.sum()


def _torch_grads(s, cap, ts=16, bg=None, masks=None, row_capacity=None, absgrad=False,
                 width=W, height=H):
    args = [torch.from_numpy(s[k]).requires_grad_() for k in NAMES]
    m2abs = torch.zeros(s["means2d"].shape, requires_grad=True) if absgrad else None
    c, a, aux = tr.rasterize_to_pixels(
        *args, width, height, torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"]), cap,
        backgrounds=None if bg is None else torch.from_numpy(bg),
        masks=None if masks is None else torch.from_numpy(masks), tile_size=ts,
        row_capacity=row_capacity, absgrad=absgrad, means2d_abs=m2abs,
    )
    tgt = torch.from_numpy(_target(tuple(c.shape)))
    _loss(c, a, tgt).backward()
    grads = [x.grad.numpy() for x in args]
    if absgrad:
        grads.append(m2abs.grad.numpy())
    return grads, aux


def _jax_grads(s, cap, ts=16, bg=None, masks=None, row_capacity=None, absgrad=False,
               width=W, height=H):
    I, N = s["depths"].shape
    tgt = jnp.asarray(_target((I, height, width, s["colors"].shape[-1])))

    def loss(m2, cn, cl, op, m2abs):
        c, a, _ = jr.rasterize_to_pixels(
            m2, cn, cl, op, width, height, jnp.asarray(s["radii"]), jnp.asarray(s["depths"]), cap,
            backgrounds=None if bg is None else jnp.asarray(bg),
            masks=None if masks is None else jnp.asarray(masks), tile_size=ts,
            row_capacity=row_capacity, absgrad=absgrad, means2d_abs=m2abs,
            pack_payload=False, pack_grads=False,
        )
        return _loss(c, a, tgt)

    args = [jnp.asarray(s[k]) for k in NAMES] + [jnp.zeros(s["means2d"].shape, jnp.float32)]
    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return [np.asarray(x) for x in (g if absgrad else g[:4])]


def _oracle_grads(s, ts=16, bg=None, width=W, height=H):
    I = s["means2d"].shape[0]
    tw, th = -(-width // ts), -(-height // ts)
    isect = isect_tiles(jnp.asarray(s["means2d"]), jnp.asarray(s["radii"]),
                        jnp.asarray(s["depths"]), ts, tw, th, capacity=8192)
    offsets = isect_offset_encode(isect.tile_keys, I, tw, th)
    tgt = jnp.asarray(_target((I, height, width, s["colors"].shape[-1])))

    def loss(*args):
        c, a = rasterize_to_pixels_ref(
            *args, width, height, ts, offsets, isect.flatten_ids, isect.n_isects,
            max_range=1024, backgrounds=None if bg is None else jnp.asarray(bg),
        )
        return _loss(c, a, tgt)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(s[k]) for k in NAMES))
    return [np.asarray(x) for x in g]


def _assert_grads_close(got, want, what, factor=1.0):
    for name, g, w in zip(NAMES + ("means2d_abs",), got, want):
        assert np.isfinite(g).all(), (what, name)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=3e-4 * scale * factor, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_gradients_match_pallas_and_oracle(ts):
    s = _scene()
    got, _ = _torch_grads(s, 4096, ts=ts)
    assert all(np.abs(g).max() > 0 for g in got)
    _assert_grads_close(got, _oracle_grads(s, ts=ts), f"oracle, tile {ts}")
    # The Pallas path's replay noise grows with the span depth: the JAX suite
    # scales its own tolerance by (ts/16)^2 at tile 32
    # (tests/test_rasterize_pallas.py:357-363).  Against the oracle the port
    # needs no such allowance.
    _assert_grads_close(got, _jax_grads(s, 4096, ts=ts), f"pallas, tile {ts}",
                        factor=max(1.0, (ts / 16.0) ** 2))
    # culled gaussians (radii 0) get exactly zero
    for g in got:
        assert (g[:, ::7] == 0).all()


def test_gradients_with_background_and_tile_masks():
    s = _scene(seed=1)
    bg = np.random.default_rng(1).random((2, 3)).astype(np.float32)
    masks = np.ones((2, -(-H // 16), -(-W // 16)), bool)
    masks[0, 0, 1] = False
    got, _ = _torch_grads(s, 4096, bg=bg, masks=masks)
    _assert_grads_close(got, _jax_grads(s, 4096, bg=bg, masks=masks), "bg + masks, pallas")
    got_bg, _ = _torch_grads(s, 4096, bg=bg)
    _assert_grads_close(got_bg, _oracle_grads(s, bg=bg), "bg, oracle")
    # the background itself is differentiable: d loss / d bg through T_final
    args = [torch.from_numpy(s[k]) for k in NAMES]
    bg_t = torch.from_numpy(bg).requires_grad_()
    c, a, _ = tr.rasterize_to_pixels(*args, W, H, torch.from_numpy(s["radii"]),
                                     torch.from_numpy(s["depths"]), 4096, backgrounds=bg_t)
    c.sum().backward()
    want = (1.0 - a.detach()).sum(dim=(1, 2))  # [I, 1] summed T_final
    np.testing.assert_allclose(bg_t.grad.numpy(), want.expand(2, 3).numpy(), rtol=1e-5)


def test_absgrad_carrier_matches_jax():
    s = _scene(seed=4)
    got, _ = _torch_grads(s, 4096, absgrad=True)
    want = _jax_grads(s, 4096, absgrad=True)
    _assert_grads_close(got, want, "absgrad")
    assert (got[4] >= 0).all() and got[4].max() > 0
    # |sum| <= sum of |.|, per gaussian and axis (with float32 slack)
    assert (np.abs(got[0]) <= got[4] + 1e-5 * max(1.0, got[4].max())).all()
    with pytest.raises(ValueError, match="means2d_abs"):
        tr.rasterize_to_pixels(
            *(torch.from_numpy(s[k]) for k in NAMES), W, H, torch.from_numpy(s["radii"]),
            torch.from_numpy(s["depths"]), 4096, absgrad=True,
        )


def _saturating_scene():
    """300 broad gaussians centred on one 16x16 tile (the scene of
    test_torch_rasterize.py:test_chunk_resume_scene_follows_oracle): slot 254
    saturates the centre pixels, slots 255+ lie behind it."""
    N = 300
    op = np.full((1, N), 0.02, np.float32)
    op[0, 254] = 0.99
    op[0, 255:] = 0.5
    colors = np.zeros((1, N, 3), np.float32)
    colors[0, :255, 1] = 1.0
    colors[0, 255:, 0] = 1.0
    return dict(
        means2d=np.full((1, N, 2), 8.0, np.float32),
        conics=np.tile(np.array([0.01, 0.0, 0.01], np.float32), (1, N, 1)),
        colors=colors, opacities=op, radii=np.full((1, N, 2), 8, np.int32),
        depths=np.linspace(1.0, 2.0, N, dtype=np.float32)[None],
    )


def test_saturating_scene_follows_the_oracle_gradient():
    """Where pixels stop, the excluded gaussian and all behind it get no
    gradient from that pixel: the oracle's rule.  The Pallas path resumes
    stopped pixels in its next 256-slot chunk (ROADMAP Queue 3), so its
    gradients for the slots behind differ and are not compared."""
    s = _saturating_scene()
    got, _ = _torch_grads(s, 1024, width=16, height=16)
    want = _oracle_grads(s, width=16, height=16)
    _assert_grads_close(got, want, "saturating scene, oracle")
    assert np.abs(want[3][0, :254]).max() > 0
    pal = _jax_grads(s, 1024, width=16, height=16)
    # the gap of the reference shows in the colours behind the stop: the
    # oracle and the port give them less weight than the Pallas path does
    assert np.abs(pal[2][0, 255:]).sum() > np.abs(got[2][0, 255:]).sum() + 1e-3


def test_truncated_capacity_gives_the_jax_gradients():
    """A small isect_capacity truncates the same slots in both packages, and
    the truncated slots get no gradient."""
    s = _scene(seed=5, N=600)
    got, aux = _torch_grads(s, 512, ts=8)
    assert bool(aux["isect_overflow"])
    _assert_grads_close(got, _jax_grads(s, 512, ts=8), "truncated")
    full, _ = _torch_grads(s, 8192, ts=8)
    assert (np.abs(full[2]).sum(-1) > 0).sum() > (np.abs(got[2]).sum(-1) > 0).sum()
    # row records truncate too
    got_r, aux_r = _torch_grads(s, 8192, ts=8, row_capacity=512)
    assert bool(aux_r["isect_overflow"])
    _assert_grads_close(got_r, _jax_grads(s, 8192, ts=8, row_capacity=512), "row-truncated")


def test_all_culled_input_has_zero_gradients():
    s = _scene(seed=6, N=40)
    s["radii"][:] = 0
    s["conics"][:] = np.nan  # culled rows may carry NaN; it must not leak
    args = [torch.from_numpy(s[k]).requires_grad_() for k in NAMES]
    c, a, aux = tr.rasterize_to_pixels(*args, W, H, torch.from_numpy(s["radii"]),
                                       torch.from_numpy(s["depths"]), 1024)
    assert int(aux["n_isects"]) == 0
    (c.sum() + a.sum()).backward()
    for x in args:
        assert (x.grad == 0).all()


def test_two_backward_runs_are_bit_equal():
    s = _scene(seed=8)
    a, _ = _torch_grads(s, 4096, absgrad=True)
    b, _ = _torch_grads(s, 4096, absgrad=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_slot_bounds_partition_the_live_slots():
    """The plan's per-gaussian slot boundaries are monotone, end at the live
    slot count and give every non-dummy gaussian its emission run."""
    s = _scene(seed=9)
    comp = tr.compact_by_depth(*(torch.from_numpy(s[k]) for k in NAMES),
                               torch.from_numpy(s["radii"]), torch.from_numpy(s["depths"]))
    plan = tr.make_tight_plan(comp.means2d, comp.radii, comp.conics, comp.opacities,
                              comp.image_ids, comp.n_live, 2, 16, 3, 3, 4096, 2048,
                              with_slot_bounds=True)
    sb = plan.slot_bounds.numpy()
    assert sb[0] == 0 and sb[-1] == int(plan.n_slots[0]) and (np.diff(sb) >= 0).all()
    gid = plan.rr[tr.RR_GID if hasattr(tr, "RR_GID") else 5].numpy()
    w = (plan.rr[1] - plan.rr[0]).numpy()
    per_g = np.bincount(gid, weights=w, minlength=len(sb) - 1)
    np.testing.assert_array_equal(np.diff(sb), per_g.astype(np.int64))
