"""Train 2D surfel gaussians (2DGS) with the PyTorch / CUDA port.

    python examples/simple_trainer_2dgs_torch.py [default|mcmc] --data npz \
        --data_dir scene.npz --max_steps 30000 [--device cpu]

The npz holds means3d, colors (0..255), viewmats, Ks, width, height.  Runs on
the CUDA card unless --device cpu.  Options are the fields of
gsplat_tpu_torch.trainer_2dgs.Config2DGS; the default strategy is the
default.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsplat_tpu_torch.trainer import config_from_args
from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS

if __name__ == "__main__":
    cfg, device = config_from_args(config_cls=Config2DGS)
    Trainer2DGS(cfg, device=device).train()
