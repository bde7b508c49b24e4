"""Find a cell's files by the names in BENCHMARK.json.

  * the configuration: `configs/<config>.json`, whose "model" names the
    adapter `models/<model>.py`;
  * the traffic mix: `traffic/<traffic>.json`, read by harness/traffic.py;
  * the check's parameters and limits: `checks/<cell>.json`;
  * each per-layer metric that the cell reports: `metrics/<metric>.py`,
    whose `read(ctx)` returns the value or None.

A cell, a configuration, a mix or a metric is added by adding its files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str, cell_e2e: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in cell_e2e


def resolve(workload: str, bench_file: Path = ROOT / "BENCHMARK.json",
            bench_dir: Path = BENCH_DIR) -> SimpleNamespace:
    spec = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}")
    w = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads((bench_dir / "checks" / f"{workload}.json").read_text())
    model = importlib.import_module(f"benchmark.models.{config['model']}")
    e2e = [SimpleNamespace(**m) for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m.name for m in e2e]
    per_layer = []
    for m in spec["per_layer"]:
        if _reports(m, workload, names):
            mod = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                              "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            per_layer.append(SimpleNamespace(name=m["name"], unit=m["unit"], read=mod.read))
    return SimpleNamespace(name=workload, chips=w["chips"], config=config, traffic=mix,
                           check=check, limits=check["limits"], model=model, end_to_end=e2e,
                           per_layer=per_layer)
