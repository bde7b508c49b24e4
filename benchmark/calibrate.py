"""Read a cell's checks on many seeds in one process, for setting its limits.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] [--seconds 5]

For each seed: the cell's set-up (with its checked units), a window of
`--seconds` (serving: long enough to pass the mix's sample), then the
program's readings against reference/; for each control seed also the
control's: the reference in the precision below the configuration's,
against the reference; for each fault seed of a training cell, the
reference with half of the image left out of the loss, against the
reference.  One JSON line per reading, then the largest program reading and
the smallest control and fault readings of each number.  The limits in
`checks/<cell>.json` lie between them (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="", help="training: the half-image fault's seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cell_mod
    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cell_mod.resolve(args.workload)
    dev = torch.device("cuda")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    program, control, fault = [], [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        sess = cell.model.open_session(cell.config, cell.traffic, cell.check, seed, dev)
        if cell.traffic["kind"] != "train":
            runner.WINDOWS[cell.traffic["kind"]](sess, args.seconds, dev)
        sess.close()
        r = sess.readings()
        program.append(r)
        print(json.dumps({"seed": seed, "program": r}), flush=True)
        if seed in control_seeds:
            c = sess.control()
            control.append(c)
            print(json.dumps({"seed": seed, "control": c}), flush=True)
        if seed in fault_seeds:
            f = sess.fault()
            fault.append(f)
            print(json.dumps({"seed": seed, "fault": f}), flush=True)
    summary = {k: {"program_max": max(r[k] for r in program),
                   "control_min": min((c[k] for c in control), default=None),
                   "fault_min": min((f[k] for f in fault), default=None)}
               for k in program[0]}
    print(json.dumps({"workload": args.workload, "seeds": len(program),
                      "control_seeds": len(control), "fault_seeds": len(fault),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
