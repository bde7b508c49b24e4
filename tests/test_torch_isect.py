"""Port parity: isect_tiles, isect_offset_encode and build_tile_worklist
against gsplat_tpu/ops/isect.py, bit for bit: every field of Isects (keys,
depths, ids, counts, n_isects, overflow), the offsets and the chunk-aligned
worklist, on scenes with culled gaussians, equal depths (the stable order),
zero and negative depths, and a capacity that cuts the list; and on the
card, isect_tiles through K8 against the same call on the CPU.  JAX is
imported by a fixture, so that the card's case runs where JAX is absent
(`pytest tests/test_torch_isect.py -m gpu --noconftest`)."""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops import gather_kernel as tg
from gsplat_tpu_torch.ops import isect as tis

TS = 16


def _scene(seed, I=2, N=300, tw=5, th=4):
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-20, TS * tw + 20, (I, N, 2)).astype(np.float32)
    radii = rng.integers(0, 40, (I, N, 2)).astype(np.int32)
    radii[:, ::6] = 0  # culled
    depths = rng.uniform(0.1, 5.0, (I, N)).astype(np.float32)
    depths[:, 10:40] = depths[:, 9:10]  # a run of equal depths
    depths[:, 41] = 0.0
    depths[:, 42] = -0.0
    depths[:, 43] = -1.5
    return means2d, radii, depths, tw, th


@pytest.fixture(scope="module")
def jax_isect():
    jnp = pytest.importorskip("jax.numpy")
    from gsplat_tpu.ops import isect as jis

    return jnp, jis


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("cap,sort", [(1 << 14, True), (700, True), (1 << 14, False)],
                         ids=["roomy", "overflow", "unsorted"])
def test_isect_tiles_matches_jax_bit_for_bit(jax_isect, cap, sort):
    jnp, jis = jax_isect
    m2, radii, depths, tw, th = _scene(0)
    want = jis.isect_tiles(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths), TS, tw, th,
                           capacity=cap, sort=sort)
    got = tis.isect_tiles(torch.from_numpy(m2), torch.from_numpy(radii), torch.from_numpy(depths),
                          TS, tw, th, capacity=cap, sort=sort)
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)
    assert bool(got.overflow) == (cap == 700)
    n = min(int(got.n_isects), cap)
    assert n > 500 and bool((got.tile_keys[n:] == 2 * tw * th).all())


@pytest.mark.parametrize("chunk", [8, 128])
def test_offsets_and_worklist_match_jax(jax_isect, chunk):
    jnp, jis = jax_isect
    m2, radii, depths, tw, th = _scene(1)
    j = jis.isect_tiles(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths), TS, tw, th,
                        capacity=1 << 14)
    t = tis.isect_tiles(torch.from_numpy(m2), torch.from_numpy(radii), torch.from_numpy(depths),
                        TS, tw, th, capacity=1 << 14)
    np.testing.assert_array_equal(tis.isect_offset_encode(t.tile_keys, 2, tw, th).numpy(),
                                  np.asarray(jis.isect_offset_encode(j.tile_keys, 2, tw, th)))
    want = jis.build_tile_worklist(j.tile_keys, 2 * tw * th, chunk)
    got = tis.build_tile_worklist(t.tile_keys, 2 * tw * th, chunk)
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_isect_tiles_empty_scene():
    m2 = torch.zeros(1, 5, 2)
    radii = torch.zeros(1, 5, 2, dtype=torch.int32)
    got = tis.isect_tiles(m2, radii, torch.ones(1, 5), TS, 3, 2, capacity=64)
    assert int(got.n_isects) == 0 and not bool(got.overflow)
    assert bool((got.tile_keys == 6).all()) and bool(torch.isinf(got.depth_keys).all())


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 14, 700, 12289])
def test_isect_tiles_through_k8_on_the_card(cap):
    """On a CUDA tensor isect_tiles launches K8; every field equals the CPU
    call's (K8's plain version) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    m2, radii, depths, tw, th = _scene(2, N=3000, tw=13, th=9)
    args = [torch.from_numpy(x) for x in (m2, radii, depths)]
    want = tis.isect_tiles(*args, TS, tw, th, capacity=cap)
    before = tg.expand_emission_aabb.launches
    got = tis.isect_tiles(*(x.cuda() for x in args), TS, tw, th, capacity=cap)
    torch.cuda.synchronize()
    assert tg.expand_emission_aabb.launches == before + 1
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
