"""The import rule: nothing the benchmark runs loads JAX or the JAX
package (top-level names compared whole: gsplat_tpu_torch is the program),
and reference/ and work/ import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness.runner import FORBIDDEN

FILES = sorted(p for p in cell_mod.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(cell_mod.BENCH_DIR)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "work"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in (cell_mod.BENCH_DIR / sub).rglob("*.py"):
        assert "gsplat_tpu_torch" not in _top_level_imports(path), path


RUN_BOTH_CELLS = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark.harness import runner
from benchmark.tests.tiny import tiny_cell
spec = json.load(open({bench!r}))
for w in spec["workloads"]:
    for traced in (False, True):
        runner.run(tiny_cell(w["name"]), 3, 0.2, traced, torch.device("cpu"), log=lambda m: None)
print(json.dumps({{"forbidden": runner.forbidden_modules(),
                  "program": "gsplat_tpu_torch" in sys.modules}}))
"""


def test_a_run_of_every_cell_loads_neither_jax_nor_the_jax_package():
    """Every module a run loads, the program's included, walked by running
    each cell (tiny, on the CPU) in a fresh interpreter."""
    code = RUN_BOTH_CELLS.format(root=str(cell_mod.ROOT),
                                 bench=str(cell_mod.ROOT / "BENCHMARK.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=cell_mod.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = __import__("json").loads(p.stdout.strip().splitlines()[-1])
    assert out == {"forbidden": [], "program": True}
