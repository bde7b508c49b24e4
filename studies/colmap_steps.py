"""Phase 16 of chip_smoke.py as a study: the COLMAP trainer's steps, with
the chip_smoke.py and the package of a given tree, on one written scene.

Run it once with `write` to write phase 16's scene (the grid scene's 9
look-at views at 3840x2160 as PNGs beside a binary model of the centre
cell's 111,785 points), then once a tree, in turns, to compare two commits
on the same card (the parent unpacked into a directory that .gitignore
lists, whose build/gsplat_tpu_torch links to this tree's when the CUDA
sources are equal):

    python3 studies/colmap_steps.py . SCENE write
    for t in build/parent . . build/parent; do python3 studies/colmap_steps.py $t SCENE; done

Each run builds the default-strategy trainer (packed, at the JAX defaults)
on the scene, sizes its capacities as chip_smoke.py does, takes 12 steps
with an eval after step 5 and prints one JSON line: each step's ms (host
clock around run_step, ending in a synchronize) and peak GiB, the losses,
the scale of the parser's first rotation block, and the step-5 PSNR and
SSIM.  One H100, about 30 s a run after the build.
"""

import json
import os
import sys

import numpy as np
import torch


def main():
    tree, scene = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))  # that tree's chip_smoke.py and package
    import chip_smoke as cs
    from gsplat_tpu_torch import trainer as trainer_mod

    dev = torch.device("cuda")
    log = lambda m: print(m, flush=True)
    if len(sys.argv) > 3:
        raw = cs.make_splats(cs.N_CELL, cs.GRID, cs.SEED)
        cs.write_colmap_scene(dev, raw, cs.N_CELL, cs.GRID, cs.SERVE_WH, scene, log)
        return
    cfg = trainer_mod.Config(data="colmap", data_dir=scene, factor=1,
                             result_dir=os.path.join(scene, f"result_{os.getpid()}"),
                             max_steps=12, eval_every=6, save_every=1000, save_ply=False,
                             sh_degree_interval=cs.TRAIN_SH_INTERVAL, fixed_batch=True,
                             seed=cs.SEED)
    tr = trainer_mod.Trainer(cfg, device=dev)
    cs.size_training_capacities(tr, log)
    targets = tr.colmap_targets()
    rec = cs.StepRecorder(tr)
    tr.train(targets=targets)
    rec.restore()
    R = tr.parser.camtoworlds[:, :3, :3].astype(np.float64)
    with open(os.path.join(cfg.result_dir, "stats", "eval_step0005.json")) as f:
        stats = json.load(f)
    print(json.dumps({"tree": tree, "step_ms": [round(r["ms"], 2) for r in rec.records],
                      "peak_gib": [round(r["peak_gib"], 3) for r in rec.records],
                      "loss": [r["loss"] for r in rec.records],
                      "rotation_scale": float(np.linalg.norm(R[0, 0])),
                      "psnr_step5": stats["psnr"], "ssim_step5": stats["ssim"]}), flush=True)


if __name__ == "__main__":
    main()
