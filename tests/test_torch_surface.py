"""The port's public surface against the JAX package's: the top-level
export lists are equal (PngCompression included), the ops lists are equal, every exported name
resolves, the seven feature probes return True, and the port-rules scan
covers every module of the package."""

import pathlib

import gsplat_tpu
import gsplat_tpu.ops
import pytest

import gsplat_tpu_torch
import gsplat_tpu_torch.geometry
import gsplat_tpu_torch.ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_top_level_exports_all_but_png_compression():
    """The name is kept from when PngCompression was missing; the lists are
    equal now."""
    assert set(gsplat_tpu.__all__) == set(gsplat_tpu_torch.__all__)
    assert len(gsplat_tpu_torch.__all__) == len(set(gsplat_tpu_torch.__all__))


def test_ops_export_lists_are_equal():
    assert sorted(gsplat_tpu.ops.__all__) == sorted(gsplat_tpu_torch.ops.__all__)


def test_geometry_export_lists_are_equal():
    import gsplat_tpu.geometry

    assert sorted(gsplat_tpu.geometry.__all__) == sorted(gsplat_tpu_torch.geometry.__all__)


@pytest.mark.parametrize("module", [gsplat_tpu_torch, gsplat_tpu_torch.ops,
                                    gsplat_tpu_torch.geometry], ids=lambda m: m.__name__)
def test_every_exported_name_resolves(module):
    missing = [n for n in module.__all__ if getattr(module, n, None) is None]
    assert not missing


def test_feature_probes_return_true():
    probes = [n for n in gsplat_tpu.__all__ if n.startswith("has_")]
    assert len(probes) == 7
    assert all(getattr(gsplat_tpu_torch, n)() is True for n in probes)


def test_port_rules_scan_every_new_module():
    from test_torch_port_rules import PORT_FILES

    scanned = {p.resolve() for p in PORT_FILES}
    for rel in ("ops/isect.py", "ops/contributing.py", "ops/rasterize_sparse.py",
                "ops/rasterize_ref.py", "ops/rasterize2d_ref.py", "ops/rasterize_eval3d_ref.py",
                "ops/projection_packed.py", "geometry/functional.py", "color_correct.py",
                "training/pose.py", "training/bilateral_grid.py", "training/ppisp.py",
                "datasets/traj.py", "compression/plas.py", "compression/png_compression.py"):
        assert (ROOT / "gsplat_tpu_torch" / rel).resolve() in scanned, rel
