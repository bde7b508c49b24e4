"""Bridge from viewer camera/state to `rasterization()` renders.

Port of `gsplat_tpu/viewer/render.py`, shared by
examples/simple_viewer_torch.py (a static scene) and the trainer's live
view (`Config.disable_viewer=False`).  Each frame is one eager call of the
port's `rasterization()` on the scene tensors' device under
`torch.no_grad()`; there is no compile cache to keep.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..rendering import rasterization
from .core import CameraState, RenderTabState

_MODES = {
    "rgb": "RGB",
    "depth(accumulated)": "RGB+D",
    "depth(expected)": "RGB+ED",
    "alpha": "RGB",
}


def make_render_fn(
    get_scene: Callable[[], Dict],
    isect_capacity: int = 4_000_000,
    sh_degree: Optional[int] = None,
    row_capacity: Optional[int] = None,
) -> Callable:
    """Build a viewer render_fn over a (possibly live) splat scene.

    `get_scene()` returns a dict with activated tensors on one device:
    means [N,3], quats [N,4], scales [N,3], opacities [N], colors ([N,D] or
    [N,K,3] SH), and optionally "sh_degree" and "n_rendered".  It is called
    on every frame, so a training loop can swap in fresh parameters between
    steps.  `isect_capacity` and `row_capacity` go to `rasterization()` as
    the serving path passes them; a frame that overflows them is drawn
    truncated, with a warning.
    """

    def render_fn(cam: CameraState, st: RenderTabState, img_wh: Tuple[int, int]):
        w, h = img_wh
        w, h = max(16, w - w % 16), max(16, h - h % 16)
        with torch.no_grad():
            scene = get_scene()
            dev = scene["means"].device
            scene_sh = scene.get("sh_degree", sh_degree)
            sh_deg = min(st.max_sh_degree, scene_sh) if scene_sh is not None else None
            viewmat = torch.from_numpy(np.linalg.inv(np.asarray(cam.c2w, np.float32))).to(dev)
            K = torch.from_numpy(cam.get_K((w, h))).to(dev)
            bg = torch.tensor(st.backgrounds, dtype=torch.float32, device=dev)
            c, a, meta = rasterization(
                scene["means"], scene["quats"], scene["scales"], scene["opacities"],
                scene["colors"], viewmat[None], K[None], w, h,
                near_plane=st.near_plane, far_plane=st.far_plane,
                radius_clip=st.radius_clip, eps2d=st.eps2d, sh_degree=sh_deg,
                render_mode=_MODES[st.render_mode], backgrounds=bg[None],
                isect_capacity=isect_capacity, row_capacity=row_capacity,
            )
        if bool(meta["isect_overflow"]):
            print(f"WARNING viewer frame {w}x{h}: intersection capacity overflow: splats "
                  f"truncated; raise isect_capacity (now {isect_capacity})", flush=True)
        c, a = c[0].cpu().numpy(), a[0].cpu().numpy()
        st.rendered_gs_count = int(scene.get("n_rendered", 0))
        if st.render_mode == "rgb":
            return c[..., :3]
        if st.render_mode == "alpha":
            return {"alpha": a}
        return {"rgb": c[..., :3], "depth": c[..., -1:], "alpha": a}

    return render_fn
