"""Port parity: the exporter against gsplat_tpu/exporter.py, byte for byte,
the PLY reader of each on the other's file, and `load_checkpoint` on a
`.ply`: the raw-parameter scene of the `.npz` branch."""

import numpy as np
import pytest
import torch

from gsplat_tpu import exporter as jexp
from gsplat_tpu_torch import exporter as texp
from gsplat_tpu_torch.scene import GaussianInferenceScene, load_checkpoint, render_scene

KEYS = ("means", "scales", "quats", "opacities", "sh0", "shN")


def _splats(n=300, sh_rest=15, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        means=rng.standard_normal((n, 3)).astype(np.float32),
        scales=(rng.standard_normal((n, 3)) - 3).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        opacities=rng.standard_normal(n).astype(np.float32),
        sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
        shN=(rng.standard_normal((n, sh_rest, 3)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("fmt", ["ply", "splat", "ply_compressed"])
@pytest.mark.parametrize("sh_rest", [0, 3, 15])
def test_bytes_equal_the_jax_exporter(fmt, sh_rest):
    sp = _splats(sh_rest=sh_rest)
    want = jexp.export_splats(**sp, format=fmt)
    assert texp.export_splats(**sp, format=fmt) == want
    # tensors are taken as they are
    assert texp.export_splats(**{k: torch.from_numpy(v) for k, v in sp.items()},
                              format=fmt) == want


def test_helpers_equal_the_jax_helpers():
    rng = np.random.default_rng(1)
    c = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(texp.sort_centers(c, np.arange(500)),
                                  jexp.sort_centers(c, np.arange(500)))
    q = rng.standard_normal((200, 4)).astype(np.float32)
    np.testing.assert_array_equal(texp.pack_rotation(q), jexp.pack_rotation(q))
    v = rng.uniform(0, 1, (3, 100))
    np.testing.assert_array_equal(texp.pack_111011(*v), jexp.pack_111011(*v))
    np.testing.assert_array_equal(texp.sh2rgb(v), jexp.sh2rgb(v))


def test_round_trip_through_both_loaders(tmp_path):
    sp = _splats()
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    texp.export_splats(**sp, format="ply", save_to=a)
    jexp.export_splats(**sp, format="ply", save_to=b)
    for path in (a, b):
        for load in (texp.load_ply_to_splats, jexp.load_ply_to_splats):
            got = load(path)
            for k in KEYS:
                np.testing.assert_array_equal(got[k], sp[k], err_msg=k)
    with open(tmp_path / "ascii.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError, match="binary little-endian"):
        texp.load_ply_to_splats(str(tmp_path / "ascii.ply"))


def test_load_checkpoint_reads_a_ply_as_the_npz_branch(tmp_path):
    """The `.ply` of the live rows and the `.npz` checkpoint of the same
    model give the same raw parameters, and the same image."""
    sp = _splats(n=40, sh_rest=3)
    sp["means"][:, 2] += 4.0
    alive = np.ones(40, bool)
    alive[::7] = False
    np.savez(tmp_path / "ckpt.npz", alive=alive, **{f"p_{k}": v for k, v in sp.items()})
    texp.export_splats(**{k: v[alive] for k, v in sp.items()}, format="ply",
                       save_to=str(tmp_path / "live.ply"))
    from_npz = load_checkpoint(str(tmp_path / "ckpt.npz"), device="cpu")
    from_ply = load_checkpoint(str(tmp_path / "live.ply"), device="cpu")
    assert from_ply.alive is None and from_ply.id == "live.ply"
    for k in KEYS:
        assert torch.equal(from_ply.splats[k], from_npz.splats[k][from_npz.alive]), k
    K = np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
    imgs = []
    for g in (from_ply, from_npz):  # the inference scene keeps the alive rows
        s = GaussianInferenceScene.from_gaussian_scene(g, id=g.id)
        c, a, _ = render_scene(s, viewmat=np.eye(4, dtype=np.float32), K=K, width=48, height=32)
        imgs.append(c)
        assert float(a.mean()) > 0
    assert torch.equal(imgs[0], imgs[1])
