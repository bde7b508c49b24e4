"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up builds the program's kernels (only
the first run in a checkout compiles; the builds stay under build/), makes
the scene and the traffic from the seed on the card, warms every shape the
cell uses and runs the cell's checked units; then the window: `--seconds`
of closed-loop work (`--trace 0`, the end-to-end metrics) or the mix's
traced units under torch.profiler (`--trace 1`, the per-layer metrics).
After the window the program is freed and what it produced is held to
reference/.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, (traced) breakdown, and the checks,
each number compared beside its limit; the checks are also the last lines
of standard error.  Exits non-zero, printing no result, without a card, or
where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cell_mod
    from benchmark.harness import runner

    cell = cell_mod.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    bad = runner.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
