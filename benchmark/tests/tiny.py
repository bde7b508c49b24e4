"""The cells cut to a size the CPU runs in seconds, on the program's plain
versions: a 1x1 grid of a few hundred points, a 96x64 image."""

from __future__ import annotations

from pathlib import Path

from benchmark.harness import cell as cell_mod


def tiny_cell(workload: str, bench_file: Path = cell_mod.ROOT / "BENCHMARK.json",
              bench_dir: Path = cell_mod.BENCH_DIR, exact: bool = False):
    """`exact`: the trainer without the bf16-pair carriers (its float32
    path, which the reference follows to round-off)."""
    c = cell_mod.resolve(workload, bench_file, bench_dir)
    c.config.update(n_cell=400, grid=1, n_gaussians=400)
    c.config["trainer"].update(cap_max=400)
    if "capacity" in c.config["trainer"]:
        c.config["trainer"].update(capacity=400)
    if exact:
        c.config["trainer"].update(pack_payload=False, pack_grads=False)
    c.traffic.update(width=96, height=64, trace_units=2)
    if c.traffic["kind"] == "serve":
        c.traffic.update(azimuths=6)
        c.check.update(sample_from=1, check_requests=1)  # the first request always comes
    else:
        c.traffic.update(views=4)
    return c
