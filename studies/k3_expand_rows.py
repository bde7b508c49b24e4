"""Design study of K3 (`expand_rows`, csrc/expand.cu) on one CUDA card.

The kernel of this checkout against the kernel of another checkout (the
parent's `gsplat_tpu_torch/csrc`, named by --parent), bit for bit and in
turns (parent, new, new, parent) on the serving request's own inputs (the
chip_smoke.py scene: 2,794,625 gaussians at 3840x2160, request 0's camera);
a split of the new kernel, each part built from a copy of csrc/expand.cu
with one line replaced: the bracket prologue alone, the staging alone (no
search, no interval: every record written empty), the staging with the
search (no interval), and the staging with the interval (no search: each
row takes the CTA's first gaussian); nvcc's registers and shared memory of
each; then the whole serving request (render_scene's fast
default) with each K3 in turns.  Prints one JSON line per measurement and
the card's name and power limit.

    python3 studies/k3_expand_rows.py --parent build/parent/gsplat_tpu_torch/csrc

Imports nothing of JAX.  Builds into build/k3_study/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gsplat_tpu_torch import _build  # noqa: E402
from gsplat_tpu_torch.ops import gather_kernel as gk  # noqa: E402
from gsplat_tpu_torch.ops import rasterize as rz  # noqa: E402

OUT = ROOT / "build" / "k3_study"
LAUNCH = ("    expand_rows_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(\n"
          "        gg_f, gg_i, E, n_rows, row_cap, tile_size, n_images, br, out);\n")
# variant -> (line of csrc/expand.cu, its replacement)
VARIANTS = {
    "prologue": (LAUNCH, ""),
    "staging": ("  if (r < *n_rows_p) {\n", "  if (false) {\n"),
    "staging_search": ("  if (j < count) {\n", "  if (j < 0) {\n"),
    "no_search": ("    int a = 0, b = count;  // the first staged gaussian with gh_in > r\n",
                  "    int a = 0, b = 0;\n"),
}
NEW_SIG = _build._SIGNATURES["expand"]["gs_expand_rows"]
OLD_SIG = NEW_SIG[:7] + NEW_SIG[9:]  # the parent's entry has no bracket scratch


def build(sources: dict) -> dict:
    """name -> csrc directory; one nvcc each, in parallel; name -> CDLL."""
    procs = {}
    for name, csrc in sources.items():
        lib = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.COMMON_FLAGS, *_build.SOURCE_FLAGS["expand"], "-o",
               str(lib), str(csrc / "expand.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        # the main kernel's registers and shared memory, from nvcc's -Xptxas -v report
        for entry, regs, st, ld in cs.ptxas_summary(out, lambda e: "expand_rows" in e):
            smem = re.findall(r"(\d+) bytes smem", out.split(entry, 2)[-1])[:1]
            print(json.dumps({"variant": name, "registers": regs, "spill_stores": st,
                              "smem_bytes": int(smem[0]) if smem else None}), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].gs_expand_rows.argtypes = OLD_SIG if name == "parent" else NEW_SIG
        libs[name].gs_expand_rows.restype = ctypes.c_int
        libs[name].gs_error_string.argtypes = [ctypes.c_int]
        libs[name].gs_error_string.restype = ctypes.c_char_p
    return libs


def k3_of(lib, old: bool):
    """expand_rows through `lib` (the parent's signature when `old`)."""

    def k3(gg_f, gg_i, n_rows, row_cap, ts, n_images):
        out = torch.empty((5, row_cap), dtype=torch.int32, device=gg_f.device)
        head = (gg_f.data_ptr(), gg_i.data_ptr(), gg_f.shape[1], n_rows.data_ptr(), row_cap,
                float(ts), n_images)
        if old:
            code = lib.gs_expand_rows(*head, out.data_ptr(), _build.stream_of(out))
        else:
            br = torch.empty((-(-row_cap // 256) + 1,), dtype=torch.int64, device=gg_f.device)
            code = lib.gs_expand_rows(*head, br.data_ptr(), br.shape[0], out.data_ptr(),
                                      _build.stream_of(out))
        _build.check(lib, code, "expand_rows")
        return tuple(out.unbind(0))

    return k3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the parent checkout's gsplat_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_expand_rows: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    sources = {"parent": Path(args.parent), "new": _build.CSRC}
    for name, (line, repl) in VARIANTS.items():
        d = OUT / name
        shutil.copytree(_build.CSRC, d)
        text = (d / "expand.cu").read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"variant {name}: the line to replace is not found once")
        (d / "expand.cu").write_text(text.replace(line, repl))
        sources[name] = d
    k3 = {name: k3_of(lib, name == "parent") for name, lib in build(sources).items()}

    dev = torch.device("cuda")
    sv = cs.Serving(dev, cs.N_CELL, cs.GRID, cs.SERVE_WH)
    sv.size_capacities()
    ki = cs.kernel_inputs(sv.scene, sv.viewmats[0], sv.K, sv.W, sv.H, cs.TILE, sv.cap,
                          sv.row_cap, False)
    args3 = ki["k3"]
    want = gk.expand_rows_plain(*args3)
    for name in ("parent", "new"):
        got = k3[name](*args3)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            print(f"k3_expand_rows: FAIL: {name} != plain", file=sys.stderr)
            return 1
    nbytes = 4 * (16 * ki["n_live"] + 1 + 5 * args3[3])
    print(json.dumps({"n_live": ki["n_live"], "n_rows": ki["n_rows"], "row_cap": args3[3],
                      "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}), flush=True)

    times = {name: [] for name in k3}
    order = ["parent", "new", "new", "parent"] + list(VARIANTS)
    for _ in range(args.rounds):
        for name in order:
            times[name].append(cs.cuda_timer(lambda: k3[name](*args3), 20))
    for name, ts in times.items():
        print(json.dumps({"kernel": name, "ms": ts}), flush=True)

    req = {"parent": [], "new": []}
    for _ in range(args.rounds):
        for name in ("parent", "new", "new", "parent"):
            rz.expand_rows = k3[name]
            req[name].append(cs.cuda_timer(lambda: sv.request(sv.viewmats[0]), 10))
    rz.expand_rows = gk.expand_rows
    for name, ts in req.items():
        print(json.dumps({"request_with": name, "ms": ts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
