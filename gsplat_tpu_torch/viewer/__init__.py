"""Interactive web viewer (upstream gsplat's viewer + nerfview, as in
gsplat_tpu.viewer).

See core.py for the server; examples/simple_viewer_torch.py for the CLI.
"""

from .core import (
    COLORMAPS,
    RENDER_MODES,
    CameraState,
    GsplatViewer,
    RenderTabState,
    apply_colormap,
    postprocess_depth,
)
from .render import make_render_fn

__all__ = [
    "make_render_fn",
    "COLORMAPS",
    "RENDER_MODES",
    "CameraState",
    "GsplatViewer",
    "RenderTabState",
    "apply_colormap",
    "postprocess_depth",
]
