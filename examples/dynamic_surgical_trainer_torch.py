"""The dynamic (G-SHARP surgical) trainer of the PyTorch port
(gsplat_tpu_torch.dynamic_trainer).

Usage:
    python examples/dynamic_surgical_trainer_torch.py --max-steps 300 [--device cpu]
    python examples/dynamic_surgical_trainer_torch.py --data endonerf --data_dir DIR \
        [--factor 4] [--device cpu]

Runs on the CUDA card unless --device names another; on the CPU the
kernels' plain versions run.  The EndoNeRF directory's PNGs are decoded
and resized without PIL.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch.dynamic_trainer import (  # noqa: E402
    Config,
    endonerf_scene,
    run_training,
    synthetic_dynamic_scene,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-steps", type=int, default=300)
    ap.add_argument("--data", default="synthetic", help="synthetic | endonerf")
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    cfg = Config(max_steps=args.max_steps)
    if args.data == "endonerf":
        if not args.data_dir:
            raise SystemExit("--data endonerf requires --data_dir")
        scene = endonerf_scene(cfg, args.data_dir, factor=args.factor)
    else:
        scene = synthetic_dynamic_scene(cfg)
    losses = run_training(cfg, scene, device=args.device)
    if args.data == "synthetic" and not losses[-1] < losses[0]:
        # the demo regime must recover the known displaced scene
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
