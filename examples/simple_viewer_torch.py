"""Interactive viewer over a trained scene, on the PyTorch / CUDA port.

The port's counterpart of examples/simple_viewer.py: the stdlib HTTP viewer
(gsplat_tpu_torch.viewer) renders frames through `rasterization()` on the
CUDA card (unless --device names another) and serves them to the browser
as PNG.

Usage:
    python examples/simple_viewer_torch.py --ckpt results/run/ckpt_2999.npz
    python examples/simple_viewer_torch.py --ply scene.ply [--device cpu]
    python examples/simple_viewer_torch.py --data scene.npz   # the garden layout
    then open http://localhost:8080

A checkpoint npz may hold the splats under "means" or "splats.means" (and
so on); with neither --ckpt nor --ply the garden-layout npz named by
--data (or GSPLAT_TPU_TEST_DATA) is read through
gsplat_tpu_torch.utils.load_test_data.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch._device import resolve_device  # noqa: E402
from gsplat_tpu_torch.viewer import GsplatViewer, RenderTabState, make_render_fn  # noqa: E402


def load_scene(args):
    """Returns (means, quats, scales, opacities, sh_or_colors, sh_degree)."""
    if args.ckpt:
        d = np.load(args.ckpt)
        pick = lambda *ks: next(d[k] for k in ks if k in d)
        means = pick("means", "splats.means")
        quats = pick("quats", "splats.quats")
        scales = np.exp(pick("scales", "splats.scales"))
        opac = 1.0 / (1.0 + np.exp(-pick("opacities", "splats.opacities")))
        if "sh0" in d or "splats.sh0" in d:
            sh0 = pick("sh0", "splats.sh0")
            shN = pick("shN", "splats.shN")
            colors = np.concatenate([sh0, shN], axis=1)
            sh_degree = int(np.sqrt(colors.shape[1]) - 1)
        else:
            colors = pick("colors", "splats.colors")
            sh_degree = None
        return means, quats, scales, opac, colors, sh_degree
    if args.ply:
        from gsplat_tpu_torch.exporter import load_ply_to_splats

        s = load_ply_to_splats(args.ply)
        colors = np.concatenate([s["sh0"], s["shN"]], axis=1)
        sh_degree = int(np.sqrt(colors.shape[1]) - 1)
        return (
            s["means"], s["quats"], np.exp(s["scales"]),
            1.0 / (1.0 + np.exp(-s["opacities"])), colors, sh_degree,
        )
    from gsplat_tpu_torch.utils.data import load_test_data

    means, quats, scales, opac, colors, _, _, _, _ = load_test_data(args.data or None)
    return means, quats, scales, opac, colors, None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--ply", type=str, default="")
    p.add_argument("--data", type=str, default="", help="a garden-layout scene npz")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--capacity", type=int, default=4_000_000)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args()

    dev = resolve_device(args.device)
    means, quats, scales, opac, colors, sh_degree = load_scene(args)
    means, quats, scales, opac, colors = (
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        for x in (means, quats, scales, opac, colors)
    )
    N = means.shape[0]
    print(f"loaded {N} splats (sh_degree={sh_degree}) on {dev}", flush=True)

    scene = {
        "means": means, "quats": quats, "scales": scales,
        "opacities": opac, "colors": colors, "sh_degree": sh_degree,
        "n_rendered": N,
    }
    render_fn = make_render_fn(lambda: scene, isect_capacity=args.capacity, sh_degree=sh_degree)

    state = RenderTabState(
        total_gs_count=N, rendered_gs_count=N,
        max_sh_degree=sh_degree if sh_degree is not None else 3,
    )
    viewer = GsplatViewer(render_fn, mode="rendering", port=args.port, state=state)
    print(f"viewer ready on port {viewer.port} — press Ctrl-C to exit", flush=True)
    while True:  # the server's thread is a daemon: Ctrl-C ends the process
        time.sleep(3600)


if __name__ == "__main__":
    main()
