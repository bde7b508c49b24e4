"""Port parity: spherical_harmonics vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.sh import spherical_harmonics as jsh
from gsplat_tpu_torch.ops.sh import spherical_harmonics as tsh


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("with_masks", [False, True])
def test_spherical_harmonics_matches_jax(degree, with_masks):
    rng = np.random.default_rng(degree)
    C, N, D = 2, 64, 3
    dirs = rng.standard_normal((C, N, 3)).astype(np.float32)
    coeffs = rng.standard_normal((N, 25, D)).astype(np.float32)  # extra bases ignored
    masks = rng.random((C, N)) > 0.3 if with_masks else None
    j = jsh(degree, jnp.asarray(dirs), jnp.asarray(coeffs),
            masks=None if masks is None else jnp.asarray(masks))
    t = tsh(degree, torch.from_numpy(dirs), torch.from_numpy(coeffs),
            masks=None if masks is None else torch.from_numpy(masks))
    # the same f32 basis formulas; the contraction's summation order differs
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    if with_masks:
        assert (t.numpy()[~masks] == 0).all()
