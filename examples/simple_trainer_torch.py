"""Train 3D gaussians with the PyTorch / CUDA port (default or MCMC strategy).

    python examples/simple_trainer_torch.py default --data npz --data_dir scene.npz \
        --max_steps 7000 [--capacity 6000000] [--device cpu]
    python examples/simple_trainer_torch.py mcmc --data npz --data_dir scene.npz \
        --max_steps 7000 --cap_max 1000000 [--device cpu]

The npz holds means3d, colors (0..255), viewmats, Ks, width, height.  Runs on
the CUDA card unless --device cpu.  Options are the fields of
gsplat_tpu_torch.trainer.Config.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsplat_tpu_torch.trainer import Trainer, config_from_args

if __name__ == "__main__":
    cfg, device = config_from_args()
    Trainer(cfg, device=device).train()
