"""Render a trained scene from an orbit of viewpoints to PNGs, with the
PyTorch / CUDA port (Stage + inference scene, render_scene's fast default).

Port of examples/sample_inference.py for the trainer's `.npz` checkpoint
(`p_*` parameters and `alive`, as examples/simple_trainer.py and
examples/simple_trainer_torch.py write them) or a 3DGS `.ply` (the
trainers' `save_ply` export): the alive rows are activated (exp, sigmoid,
unit quats), packed into a GaussianInferenceScene through
`from_gaussian_tensors`, registered on a Stage and rendered through
render_scene at its default, the bf16-pair packed fast path.

    python examples/sample_inference_torch.py --ckpt results/run/ckpt_6999.npz \
        --output-dir results/sample_inference --n-views 8 [--device cpu]

Runs on the CUDA card unless --device cpu.  The PNGs are written with
zlib (`gsplat_tpu_torch.datasets.encode_png`), no imaging package.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.datasets import encode_png
from gsplat_tpu_torch.scene import GaussianInferenceScene, Stage, load_checkpoint, render_scene


def orbit_cameras(center, radius, height, n_views, fov_deg, W, H):
    """n_views world-to-camera matrices on a circle around `center`, looking
    at it, and the pinhole K of a `fov_deg` horizontal field of view."""
    f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    viewmats = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = center + np.array([radius * math.cos(a), radius * math.sin(a), height])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, np.array([0.0, 0.0, -1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])  # world -> camera rows
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ eye
        viewmats.append(w2c)
    return np.stack(viewmats), K


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB image [H, W, 3] as a PNG: one IDAT of unfiltered rows."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="the trainer's .npz checkpoint or a .ply")
    ap.add_argument("--output-dir", default="results/sample_inference")
    ap.add_argument("--n-views", type=int, default=8)
    ap.add_argument("--width", type=int, default=648)
    ap.add_argument("--height", type=int, default=420)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--isect-capacity", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    gscene = load_checkpoint(args.ckpt, device=dev)
    print(f"loaded {gscene.id}: {gscene.num_gaussians} gaussians")

    # activate the alive rows and pack them for inference
    sp = {k: v.cpu().numpy() for k, v in gscene.splats.items()}
    keep = (np.nonzero(gscene.alive.cpu().numpy())[0] if gscene.alive is not None
            else np.arange(len(sp["means"])))
    sh = np.concatenate([sp["sh0"], sp["shN"]], axis=1)[keep]
    sh_degree = math.isqrt(sh.shape[1]) - 1
    quats = sp["quats"][keep]
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    inf_scene = GaussianInferenceScene.from_gaussian_tensors(
        sp["means"][keep], quats, np.exp(sp["scales"][keep]),
        1.0 / (1.0 + np.exp(-sp["opacities"][keep])), sh, sh_degree=sh_degree,
        id=gscene.id, device=dev,
    )
    stage = Stage()
    stage.add_scene(gscene, lambda splats, alive=None, **kw: render_scene(inf_scene, **kw))

    means = sp["means"][keep]
    center = np.median(means, axis=0)
    radius = 1.5 * float(np.percentile(np.linalg.norm(means - center, axis=1), 70))
    viewmats, K = orbit_cameras(center, radius, -0.3 * radius, args.n_views, args.fov,
                                args.width, args.height)
    outs = []
    for i, vm in enumerate(viewmats):
        img, _, meta = stage.render(gscene.id, viewmat=vm, K=K, width=args.width,
                                    height=args.height, isect_capacity=args.isect_capacity)
        if bool(meta["isect_overflow"]):
            print(f"WARNING view {i}: isect overflow; raise --isect-capacity", flush=True)
        arr = (np.clip(img[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        out = os.path.join(args.output_dir, f"view_{i:03d}.png")
        write_png(out, arr)
        outs.append(out)
        print(f"{out}  (path={meta['render_path']})", flush=True)
    return outs


if __name__ == "__main__":
    main()
