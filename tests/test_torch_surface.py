"""The port's public surface against the JAX package's: the top-level
export lists are equal (PngCompression included), the ops and viewer lists are equal, the
utils list holds the JAX one, every exported name resolves, the seven feature probes return
True, the port-rules scan covers every module of the package, and ops.normalize takes the
JAX keywords."""

import pathlib

import gsplat_tpu
import gsplat_tpu.ops
import pytest

import gsplat_tpu_torch
import gsplat_tpu_torch.geometry
import gsplat_tpu_torch.ops
import gsplat_tpu_torch.utils
import gsplat_tpu_torch.viewer

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


def test_viewer_export_list_equals_the_jax_list():
    import gsplat_tpu.viewer

    assert gsplat_tpu_torch.viewer.__all__ == gsplat_tpu.viewer.__all__


def test_utils_export_list_holds_the_jax_list():
    import gsplat_tpu.utils

    assert set(gsplat_tpu.utils.__all__) <= set(gsplat_tpu_torch.utils.__all__)
    assert {"depth_to_normal", "depth_to_points", "synthetic_test_data"} <= set(
        gsplat_tpu_torch.utils.__all__)


@pytest.mark.parametrize("module", [gsplat_tpu_torch, gsplat_tpu_torch.ops,
                                    gsplat_tpu_torch.geometry, gsplat_tpu_torch.utils,
                                    gsplat_tpu_torch.viewer], ids=lambda m: m.__name__)
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
                "datasets/traj.py", "compression/plas.py", "compression/png_compression.py",
                "viewer/core.py", "viewer/page.py", "viewer/render.py", "viewer/__init__.py",
                "io_native.py", "profile.py", "utils/trace.py", "utils/data.py"):
        assert (ROOT / "gsplat_tpu_torch" / rel).resolve() in scanned, rel
    assert (ROOT / "examples" / "simple_viewer_torch.py").resolve() in scanned


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_normalize_takes_the_jax_axis_keyword(axis):
    """ops.normalize(x, axis=..., eps=...) as gsplat_tpu/ops/math.py:19 has it,
    zero vectors included."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    x = np.random.default_rng(axis + 3).standard_normal((4, 5, 3)).astype(np.float32)
    x[0, 0] = 0.0
    x[:, 2, :] = 0.0
    want = np.asarray(gsplat_tpu.ops.normalize(jnp.asarray(x), axis=axis, eps=1e-12))
    got = gsplat_tpu_torch.ops.normalize(torch.from_numpy(x), axis=axis, eps=1e-12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)



@pytest.mark.parametrize("name", ["parallel", "contrib.dynamic"])
def test_export_lists_of_the_last_modules_are_equal(name):
    import importlib

    jax_mod = importlib.import_module(f"gsplat_tpu.{name}")
    port_mod = importlib.import_module(f"gsplat_tpu_torch.{name}")
    assert sorted(port_mod.__all__) == sorted(jax_mod.__all__)
    assert all(getattr(port_mod, n, None) is not None for n in port_mod.__all__)


def test_distributed_defines_the_jax_functions():
    """gsplat_tpu/distributed.py has no __all__: its public functions."""
    import importlib
    import inspect

    def public(mod):
        return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
                if f.__module__ == mod.__name__ and not n.startswith("_")}

    assert public(importlib.import_module("gsplat_tpu_torch.distributed")) == public(
        importlib.import_module("gsplat_tpu.distributed"))


def test_port_rules_scan_the_distributed_dynamic_and_ncore_modules():
    from test_torch_port_rules import PORT_FILES

    scanned = {p.resolve() for p in PORT_FILES}
    for rel in ("distributed.py", "parallel/__init__.py", "parallel/render.py",
                "contrib/dynamic/hexplane.py", "contrib/dynamic/deformation.py",
                "contrib/dynamic/regulation.py", "contrib/dynamic/strategy.py",
                "dynamic_trainer.py", "datasets/endonerf.py", "datasets/ncore.py",
                "datasets/normalize.py", "datasets/resize.py"):
        assert (ROOT / "gsplat_tpu_torch" / rel).resolve() in scanned, rel
    for rel in ("image_fitting_torch.py", "dynamic_surgical_trainer_torch.py"):
        assert (ROOT / "examples" / rel).resolve() in scanned, rel
