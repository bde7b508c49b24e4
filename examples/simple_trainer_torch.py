"""Train 3D gaussians with the PyTorch / CUDA port (default or MCMC strategy).

    python examples/simple_trainer_torch.py default --data_dir scene/ --factor 4 \
        --save_ply true
    python examples/simple_trainer_torch.py default --data npz --data_dir scene.npz \
        --max_steps 7000 [--capacity 6000000] [--device cpu]
    python examples/simple_trainer_torch.py mcmc --data npz --data_dir scene.npz \
        --max_steps 7000 --cap_max 1000000 [--device cpu]

A COLMAP scene (the default data) holds sparse/0 and images_{factor}; the npz
holds means3d, colors (0..255), viewmats, Ks, width, height.  Runs on the
CUDA card unless --device cpu.  Options are the fields of
gsplat_tpu_torch.trainer.Config; the render takes the bf16-pair packed sort
payload and per-slot gradients unless --pack_payload false --pack_grads false
(the exact float32 path).  The JAX trainer's add-ons:

    --pose_opt true [--pose_opt_lr 1e-5 --pose_opt_reg 1e-6 --pose_noise 0]
    --app_opt true [--app_embed_dim 16 --app_opt_lr 1e-3 --app_opt_reg 1e-6]
    --bilateral_grid true [--bilateral_grid_shape 16,16,8 --tv_reg 10]
    --ppisp true [--ppisp_lr 1e-3 --ppisp_reg 1e-3]
    --render_traj true [--render_traj_path interp|raw|ellipse|spiral --traj_frames 60]
    --compression png                    (PNG planes in result_dir/compression)
    --tb_every 100 [--tb_save_image true] (TensorBoard, where it is installed)
    --npz_traj_views N [--npz_eval_every 8] (npz: train on a path of N views)

    --disable_viewer false [--viewer_port 8080] (the live viewer: open
                                         http://localhost:8080 while it trains)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsplat_tpu_torch.trainer import Trainer, config_from_args

if __name__ == "__main__":
    cfg, device = config_from_args()
    Trainer(cfg, device=device).train()
