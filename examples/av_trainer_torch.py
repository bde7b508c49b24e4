"""The AV trainer of the PyTorch port: cameras and a spinning lidar trained
jointly (gsplat_tpu_torch.av_trainer).

Usage:
    python examples/av_trainer_torch.py --data synthetic --max-steps 200 [--device cpu]

Runs on the CUDA card unless --device names another; on the CPU the
kernels' plain versions run.  `--data ncore` opens an NCore sequence from
its meta-json, which needs the NCore SDK adapter; that adapter is not
ported, so the option refuses (SystemExit).  In Python,
`gsplat_tpu_torch.av_trainer.ncore_scene` takes an in-memory
SequenceSource (gsplat_tpu_torch/datasets/ncore.py) and `AVRunner` trains
on it.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch.av_trainer import AVRunner, Config, synthetic_scene  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="synthetic", help="synthetic | ncore (refused: no SDK)")
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--result-dir", default="/tmp/av_trainer")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    if args.data == "ncore":
        raise SystemExit(
            "--data ncore opens an NCore sequence from its meta-json, which needs the NCore SDK "
            "adapter (examples/datasets/ncore.py:open_ncore_sequence); that adapter is not "
            "ported. gsplat_tpu_torch.av_trainer.ncore_scene takes an in-memory SequenceSource.")
    if args.data != "synthetic":
        raise SystemExit("unknown --data (synthetic | ncore)")
    cfg = Config(data=args.data, max_steps=args.max_steps, result_dir=args.result_dir)
    runner = AVRunner(cfg, synthetic_scene(device=args.device), device=args.device)
    losses = runner.train()
    if losses[-1] > losses[0]:
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
