"""One run of one cell: set-up, the measured (or traced) window, the check,
and the result line.

The cell's files are found by name (harness/cell.py); the configuration
names its adapter (`models/<model>.py`), which opens a session on the
program.  The window is closed-loop: a "train" mix dispatches steps until
the window's seconds are up and then waits for the card, a "serve" mix
sends one request at a time and waits for each image.  Every rate is all
the window's work over all its time, the tail is over all its requests.
"""

from __future__ import annotations

import statistics
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List

import torch

from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the uptime, both from /proc)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _stream_sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream().synchronize()


def train_window(sess, seconds: float, device) -> dict:
    _sync(device)
    outs, i = [], sess.done
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        outs.append(sess.unit(i))
        i += 1
    _sync(device)
    T = time.perf_counter() - t0
    failed = sess.failed(outs)
    return dict(attempted=len(outs), failed=failed,
                metrics={"train_steps_per_s": (len(outs) - failed) / T})


def serve_window(sess, seconds: float, device) -> dict:
    _sync(device)
    outs, lat, i = [], [], sess.done
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        outs.append(sess.unit(i))
        _stream_sync(device)
        lat.append(time.perf_counter() - ts)
        i += 1
    _sync(device)
    T = time.perf_counter() - t0
    failed = sess.failed(outs)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0]
    return dict(attempted=len(outs), failed=failed,
                metrics={"render_fps": (len(outs) - failed) / T, "render_p95_ms": p95 * 1e3})


WINDOWS: Dict[str, Callable] = {"train": train_window, "serve": serve_window}


def traced_window(sess, n_units: int, device):
    """The mix's traced units under torch.profiler.  On the card it records
    the device's operations and the CUDA runtime calls only: recording
    every host operator as well slowed a 4k 3DGS training step by half on
    an H100, and the idle share would read that slowing."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    first = sess.done
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        outs = [sess.unit(first + k) for k in range(n_units)]
        _sync(device)
        window_s = time.perf_counter() - t0
    tr = trace_mod.reduce(prof.events(), n_units, window_s)
    return tr, outs, list(range(first, first + n_units))


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """The result line's object."""
    mix, cfg = cell.traffic, cell.config
    sess = cell.model.open_session(cfg, mix, cell.check, seed, device, traced)
    setup_s = process_age_s()
    if traced:
        tr, outs, units = traced_window(sess, mix["trace_units"], device)
        res = dict(attempted=len(outs), failed=sess.failed(outs), metrics={})
    else:
        res = WINDOWS[mix["kind"]](sess, seconds, device)
        res["metrics"]["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    res["metrics"]["peak_mem_gib"] = peak / 2 ** 30
    sess.close()
    readings = sess.readings()
    limits = cell.limits
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if traced:
        ctx = SimpleNamespace(trace=tr, work=sess.work(units))
        for m in cell.per_layer:
            value = m.read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": res["metrics"][m.name], "unit": m.unit}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device_info(device, peak, cell.chips)}
    if traced:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = trace_mod.breakdown(tr)
    line["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return line


def device_info(device: torch.device, peak: int, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": peak}
