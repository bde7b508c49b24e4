"""The harness on the CPU: every cell resolves to its files, a cell and a
metric are added as files alone, a run's result line has the contract's
keys, and run.py refuses to run without a card."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import runner, traffic
from benchmark.harness import scene as scene_mod
from benchmark.tests.tiny import tiny_cell

SPEC = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    c = cell_mod.resolve(workload)
    w = next(w for w in SPEC["workloads"] if w["name"] == workload)
    assert c.config["name"] == w["config"]
    assert c.traffic["kind"] in runner.WINDOWS
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert "setup_s" in [m.name for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(m.read)


def test_configs_name_their_files_and_sources():
    for cfg in SPEC["configs"]:
        path = cell_mod.ROOT / cfg["file"]
        data = json.loads(path.read_text())
        assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
        assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


def _tree_digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    """A throwaway traffic mix, cell, check and per-layer metric, written
    as new files beside copies of the benchmark's, run end to end; no file
    of the benchmark changes."""
    before = _tree_digest(cell_mod.BENCH_DIR)
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(cell_mod.BENCH_DIR / sub, bench / sub)
    mix = json.loads((bench / "traffic" / "serve-4k.json").read_text())
    mix.update(azimuths=4)
    (bench / "traffic" / "serve-few.json").write_text(json.dumps(mix))
    (bench / "checks" / "grid5-3dgs.serve-few.json").write_text(
        (bench / "checks" / "grid5-3dgs.serve-4k.json").read_text())
    (bench / "metrics" / "units_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.units)\n")
    spec = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "grid5-3dgs.serve-few", "config": "grid5-3dgs",
                              "traffic": "serve-few", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher",
                              "source": "device_trace", "layer": "entry", "moves": "render_fps",
                              "workloads": ["grid5-3dgs.serve-few"]})
    for m in spec["end_to_end"]:
        if "grid5-3dgs.serve-4k" in m.get("workloads", []):
            m["workloads"].append("grid5-3dgs.serve-few")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = tiny_cell("grid5-3dgs.serve-few", tmp_path / "BENCHMARK.json", bench)
    assert c.traffic["azimuths"] == 6  # tiny_cell's cut over the new mix
    line = runner.run(c, 5, 0.2, True, torch.device("cpu"), log=lambda m: None)
    assert line["metrics"]["units_traced"]["value"] == c.traffic["trace_units"]
    assert _tree_digest(cell_mod.BENCH_DIR) == before


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_the_result_line_has_the_contracts_keys(workload, traced):
    c = tiny_cell(workload)
    line = runner.run(c, 2**31 + 7, 0.3, traced, torch.device("cpu"), log=lambda m: None)
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys) == set(LINE_KEYS) | {"checks"} | ({"breakdown"} if traced else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c_ in line["checks"].items():
        assert set(c_) == {"value", "limit"}
    want = {m.name for m in (c.per_layer if traced else c.end_to_end)}
    got = set(line["metrics"])
    # on the CPU the trace has no device events: the readers of device time
    # find nothing and the harness leaves their metrics out
    assert got <= want and (traced or got == want)
    json.dumps(line)


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in SPEC["workloads"]}))
def test_a_mix_with_an_unread_key_is_refused(mix):
    m = json.loads((cell_mod.BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    traffic.check_keys(m)
    for extra in ({"batch": 4}, {"clients": 4}):
        with pytest.raises(ValueError, match="unread"):
            traffic.check_keys(dict(m, **extra))


@pytest.mark.parametrize("workload", ["grid5-3dgs.train-4k", "grid5-2dgs.train-4k"])
def test_a_strategy_field_the_program_does_not_run_is_refused(workload):
    c = tiny_cell(workload)
    c.config["strategy_fields"]["refine_stop_iter"] += 1
    with pytest.raises(ValueError, match="refine_stop_iter"):
        c.model.open_session(c.config, c.traffic, c.check, 3, "cpu")


def test_a_scene_of_another_count_than_the_configurations_is_refused():
    c = tiny_cell("grid5-3dgs.serve-4k")
    c.config["n_gaussians"] += 1
    with pytest.raises(ValueError, match="n_gaussians"):
        scene_mod.make_scene(c.config, 1, "cpu")


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    p = subprocess.run([sys.executable, str(cell_mod.BENCH_DIR / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=cell_mod.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsplat_tpu_torch_like", sys)
    assert "gsplat_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gsplat_tpu.fake", sys)
    assert runner.forbidden_modules() == ["gsplat_tpu"]
