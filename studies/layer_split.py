"""A benchmark cell's traced units split by the program's spans, and what
recording the spans costs.

    python3 studies/layer_split.py --workload grid5-3dgs.train-4k --seed 7 [--units 8]
        [--cost-windows 4 --cost-seconds 4] [--out split.jsonl]

The cell's session is opened as benchmark/run.py opens it (the seeded
scene and traffic, the warm-up and the checked units); then the cell's
traced units run under the benchmark's device-only torch.profiler inside
`gsplat_tpu_torch.utils.trace.recording()`, and harness/spans.py joins the
two: ms a unit by layer (they sum to the window), device-busy and idle ms
by span, host syncs a unit, the plan's fill, the launches a unit and the
idle share as harness/trace.py reads them, and the span of every launch
of the named kernels.  Before that, `--cost-windows` pairs of closed-loop
windows of `--cost-seconds` each, recording off and on in turns (no
profiler), give the cost of recording: (on - off) / off of the ms a unit,
per pair.
One JSON object goes to standard output and to `--out`.  On the card (the
kernels build on a checkout's first run); `--device cpu` runs the plain
versions, for a rehearsal on a cell cut to size by benchmark/tests/tiny.py.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the 3DGUT projection's child spans, which the benchmark's table
# (benchmark/harness/spans.py:LAYER_OF) does not list: the split is given
# by that table, and again with these spans read as the projection layer
PROJECT_CHILDREN = {"project.ut": "project", "project.rays": "project"}

# kernel name -> the spans its every launch must fall in
KERNELS = {
    "K1p": (re.compile(r"rasterize_fwd_kernel<\d+, (true|false), true>"
                       r"|rasterize_fwd_kernelILi\d+ELb[01]ELb1E"), {"composite"}),
    "K2p": (re.compile(r"rasterize_bwd_kernel<\d+, true>|rasterize_bwd_kernelILi\d+ELb1E"),
            {"composite.bwd"}),
    "K6a": (re.compile(r"rasterize2d_fwd"), {"composite"}),
    "K6b": (re.compile(r"rasterize2d_bwd"), {"composite.bwd"}),
    "K7a": (re.compile(r"rasterize_eval3d_fwd"), {"composite"}),
    "K7b": (re.compile(r"rasterize_eval3d_bwd"), {"composite.bwd"}),
    "K8": (re.compile(r"expand_aabb_kernel"), {"sort"}),
    "K9": (re.compile(r"gather_records_kernel"), {"sort"}),
    "K5": (re.compile(r"segment_rowsum"), {"reduce.bwd"}),
    "radix sort": (re.compile(r"RadixSort"), {"sort"}),
    "project_shade": (re.compile(r"project_shade_kernel"), {"project"}),
}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _units(sess, first: int, n: int, serve: bool, device) -> list:
    outs = []
    for i in range(first, first + n):
        outs.append(sess.unit(i))
        if serve and device.type == "cuda":
            torch.cuda.current_stream().synchronize()
    return outs


def split(sess, n: int, serve: bool, device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spans as spans_mod
    from benchmark.harness import trace as trace_mod
    from gsplat_tpu_torch.utils.trace import recording

    _sync(device)
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with recording() as rec:  # counters are read at its close, after the trace
        with profile(activities=acts) as prof:
            t0, p0 = time.time_ns(), time.perf_counter()
            _units(sess, sess.done, n, serve, device)
            _sync(device)
            t1, p1 = time.time_ns(), time.perf_counter()
    sess.done += n
    start = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    window = ((t0 - start) / 1e3, (t1 - start) / 1e3)
    s = spans_mod.attribute(events, rec.spans, rec.counters, start, window)
    merged = [sp._replace(name=PROJECT_CHILDREN.get(sp.name, sp.name)) for sp in rec.spans]
    sm = spans_mod.attribute(events, merged, rec.counters, start, window)
    tr = trace_mod.reduce(events, n, p1 - p0)
    by_kernel = collections.defaultdict(collections.Counter)
    sorts = collections.defaultdict(collections.Counter)
    for op, span in spans_mod.operation_spans(events, rec.spans, start):
        for k, (pat, _) in KERNELS.items():
            if pat.search(op):
                by_kernel[k][span] += 1
        if KERNELS["radix sort"][0].search(op):
            sorts[op[:160]][span] += 1
    return dict(
        units=s.units, window_ms=s.window_ms, layer_ms=s.layer_ms,
        layers_sum_ms=sum(s.layer_ms.values()),
        other_share=s.layer_ms["other"] / s.window_ms,
        layer_ms_project_children=sm.layer_ms,
        other_share_project_children=sm.layer_ms["other"] / sm.window_ms,
        device_ms_by_span=s.device_ms_by_span, idle_by_span=s.idle_by_span,
        host_syncs_per_unit=s.host_syncs_per_unit, syncs_by_span=s.syncs_by_span,
        isect_fill=s.isect_fill, launches_per_unit=tr.device_ops / n,
        device_idle_share=100.0 * (1.0 - tr.busy_s / tr.window_s),
        host_window_ms=1e3 * (p1 - p0) / n,
        device_ops_ms={name[:120]: 1e3 * sec / n for name, sec in
                       sorted(tr.op_seconds.items(), key=lambda kv: -kv[1])[:10]},
        kernels={k: dict(c) for k, c in by_kernel.items()},
        kernels_in_place={k: set(c) <= KERNELS[k][1] for k, c in by_kernel.items()},
        radix_sorts={k: dict(c) for k, c in sorts.items()},
        spans_per_unit=len(rec.spans) / n, counters_per_unit=len(rec.counters) / n,
    )


def cost(sess, windows: int, seconds: float, serve: bool, device) -> dict:
    """ms a unit with recording off and on, in turns, each over a closed-loop
    window of `seconds` ending in a synchronize."""
    from gsplat_tpu_torch.utils.trace import recording

    def window(on: bool) -> float:
        _sync(device)
        k, t0 = 0, time.perf_counter()
        with recording() if on else contextlib.nullcontext():
            while time.perf_counter() - t0 < seconds:
                _units(sess, sess.done + k, 1, serve, device)
                k += 1
            _sync(device)
            dt = time.perf_counter() - t0
        sess.done += k
        return 1e3 * dt / k

    off, on = [], []
    for w in range(windows):
        for flag in ((False, True) if w % 2 == 0 else (True, False)):
            (on if flag else off).append(window(flag))
    rel = [(b - a) / a for a, b in zip(off, on)]
    return dict(off_ms=off, on_ms=on, cost=rel, median_cost=statistics.median(rel))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=0, help="0: the mix's trace_units")
    ap.add_argument("--cost-windows", type=int, default=0)
    ap.add_argument("--cost-seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from benchmark.harness import cell as cell_mod

    device = torch.device(args.device)
    if device.type == "cpu":
        from benchmark.tests.tiny import tiny_cell

        cell = tiny_cell(args.workload)
    else:
        cell = cell_mod.resolve(args.workload)
    mix = cell.traffic
    serve = mix["kind"] == "serve"
    sess = cell.model.open_session(cell.config, mix, cell.check, args.seed, device, True)
    out = dict(workload=args.workload, seed=args.seed, torch=torch.__version__)
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    if args.cost_windows:  # first: the trace's events would grow the heap the GC walks
        out["cost"] = cost(sess, args.cost_windows, args.cost_seconds, serve, device)
    out["split"] = split(sess, args.units or mix["trace_units"], serve, device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    sess.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
