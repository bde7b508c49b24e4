"""Interactive web viewer for scenes of the PyTorch port.

Port of `gsplat_tpu/viewer/core.py`: a self-contained stdlib
`ThreadingHTTPServer` serving a single-page orbit-controls client that
POSTs camera poses; frames are rendered server-side, on the scene's device,
through the caller-supplied `render_fn`, and streamed back as PNG (the JAX
viewer sends JPEG through PIL, which the card's machine does not have; the
port's own writer, `datasets.encode_png`, needs none).  The endpoints are
the JAX viewer's: `/` (the page), `/info`, `/state`, `/render`.

The control surface mirrors upstream gsplat's `GsplatRenderTabState`: max
SH degree, near/far planes, radius_clip, eps2d, background colour, render
mode (rgb / depth(accumulated) / depth(expected) / alpha), near/far
normalisation, inverse depth, colormap, camera model.  Training mode adds
the nerfview pause/resume contract: the trainer shares `viewer.lock` and
calls `viewer.update(step)`, while the browser's Pause button flips
`viewer.state.paused`, which `update` honours between steps.

A `render_fn` that raises answers HTTP 500 with its message, as in the JAX
viewer; here the server's `handle_error`, which socketserver calls with the
exception in hand, writes that answer.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np

from ..datasets.colmap import encode_png

RENDER_MODES = ("rgb", "depth(accumulated)", "depth(expected)", "alpha")
COLORMAPS = ("turbo", "viridis", "magma", "inferno", "cividis", "gray")
PNG_LEVEL = 1  # zlib level of the frames: the fastest that compresses


@dataclass
class CameraState:
    """Camera for a single viewer render request (nerfview CameraState)."""

    c2w: np.ndarray  # [4, 4] OpenCV camera-to-world
    fov: float  # vertical field of view, radians
    aspect: float  # width / height

    def get_K(self, img_wh: Tuple[int, int]) -> np.ndarray:
        w, h = img_wh
        fy = 0.5 * h / np.tan(0.5 * self.fov)
        fx = fy
        return np.array(
            [[fx, 0.0, w / 2.0], [0.0, fy, h / 2.0], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclass
class RenderTabState:
    """Viewer-controllable render parameters (upstream gsplat's
    GsplatRenderTabState)."""

    # non-controllable (display only)
    total_gs_count: int = 0
    rendered_gs_count: int = 0
    # controllable
    max_sh_degree: int = 3
    near_plane: float = 1e-2
    far_plane: float = 1e2
    radius_clip: float = 0.0
    eps2d: float = 0.3
    backgrounds: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    render_mode: str = "rgb"
    normalize_nearfar: bool = False
    inverse: bool = False
    colormap: str = "turbo"
    rasterize_mode: str = "classic"
    camera_model: str = "pinhole"
    # viewer plumbing
    viewer_res: int = 1080  # max render height
    paused: bool = False  # training-mode pause toggle

    def to_dict(self) -> dict:
        return {
            "total_gs_count": self.total_gs_count,
            "rendered_gs_count": self.rendered_gs_count,
            "max_sh_degree": self.max_sh_degree,
            "near_plane": self.near_plane,
            "far_plane": self.far_plane,
            "radius_clip": self.radius_clip,
            "eps2d": self.eps2d,
            "backgrounds": list(self.backgrounds),
            "render_mode": self.render_mode,
            "normalize_nearfar": self.normalize_nearfar,
            "inverse": self.inverse,
            "colormap": self.colormap,
            "rasterize_mode": self.rasterize_mode,
            "camera_model": self.camera_model,
            "viewer_res": self.viewer_res,
            "paused": self.paused,
        }

    def apply(self, upd: dict) -> None:
        for k, v in upd.items():
            if k in ("total_gs_count", "rendered_gs_count"):
                continue
            if hasattr(self, k):
                cur = getattr(self, k)
                if isinstance(cur, tuple):
                    v = tuple(float(x) for x in v)
                elif isinstance(cur, bool):
                    v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                setattr(self, k, v)


# 17 anchors of each colormap, cm(i / 16)[:3] of matplotlib 3.10.8 as
# float32 (the JAX viewer reads them from matplotlib where it is installed,
# else shows gray); linear interpolation between anchors is visually
# indistinguishable at 8 bits
_LUT_ANCHORS = {
    "turbo": (
        (0.18995, 0.07176, 0.23217),
        (0.25107, 0.25237, 0.63374),
        (0.27628, 0.42118, 0.89123),
        (0.25862, 0.57958, 0.99876),
        (0.15844, 0.73551, 0.92305),
        (0.09267, 0.86554, 0.7623),
        (0.19659, 0.94901, 0.59466),
        (0.42778, 0.99419, 0.38575),
        (0.64362, 0.98999, 0.23356),
        (0.80473, 0.92452, 0.20459),
        (0.93301, 0.81236, 0.22667),
        (0.99314, 0.67408, 0.20348),
        (0.9836, 0.49291, 0.12849),
        (0.92105, 0.31489, 0.05475),
        (0.81608, 0.18462, 0.01809),
        (0.66449, 0.08436, 0.00424),
        (0.4796, 0.01583, 0.01055),
    ),
    "viridis": (
        (0.267004, 0.004874, 0.329415),
        (0.282327, 0.094955, 0.417331),
        (0.278826, 0.17549, 0.483397),
        (0.258965, 0.251537, 0.524736),
        (0.229739, 0.322361, 0.545706),
        (0.19943, 0.387607, 0.554642),
        (0.172719, 0.448791, 0.557885),
        (0.149039, 0.508051, 0.55725),
        (0.127568, 0.566949, 0.550556),
        (0.120638, 0.625828, 0.533488),
        (0.157851, 0.683765, 0.501686),
        (0.24607, 0.73891, 0.452024),
        (0.369214, 0.788888, 0.382914),
        (0.515992, 0.831158, 0.294279),
        (0.678489, 0.863742, 0.189503),
        (0.845561, 0.887322, 0.099702),
        (0.993248, 0.906157, 0.143936),
    ),
    "magma": (
        (0.001462, 0.000466, 0.013866),
        (0.039608, 0.03109, 0.133515),
        (0.113094, 0.065492, 0.276784),
        (0.211718, 0.061992, 0.418647),
        (0.316654, 0.07169, 0.48538),
        (0.414709, 0.110431, 0.504662),
        (0.512831, 0.148179, 0.507648),
        (0.613617, 0.181811, 0.498536),
        (0.716387, 0.214982, 0.47529),
        (0.816914, 0.255895, 0.436461),
        (0.904281, 0.31961, 0.388137),
        (0.960949, 0.418323, 0.35963),
        (0.9867, 0.535582, 0.38221),
        (0.996096, 0.653659, 0.446213),
        (0.996898, 0.769591, 0.534892),
        (0.99244, 0.88433, 0.640099),
        (0.987053, 0.991438, 0.749504),
    ),
    "inferno": (
        (0.001462, 0.000466, 0.013866),
        (0.042253, 0.028139, 0.141141),
        (0.129285, 0.047293, 0.290788),
        (0.238273, 0.036621, 0.396353),
        (0.3415, 0.062325, 0.429425),
        (0.441207, 0.099338, 0.431594),
        (0.54092, 0.134729, 0.415123),
        (0.640135, 0.171438, 0.381065),
        (0.735683, 0.215906, 0.330245),
        (0.822386, 0.275197, 0.266085),
        (0.894305, 0.353399, 0.193584),
        (0.946965, 0.449191, 0.115272),
        (0.978422, 0.557937, 0.034931),
        (0.987874, 0.675267, 0.065257),
        (0.974638, 0.797692, 0.206332),
        (0.947594, 0.917399, 0.410665),
        (0.988362, 0.998364, 0.644924),
    ),
    "cividis": (
        (0.0, 0.135112, 0.304751),
        (0.0, 0.178802, 0.414764),
        (0.103401, 0.220406, 0.43579),
        (0.195057, 0.264372, 0.425924),
        (0.263738, 0.307831, 0.422789),
        (0.32425, 0.351289, 0.42625),
        (0.38083, 0.395164, 0.435653),
        (0.435168, 0.439763, 0.451134),
        (0.488697, 0.485318, 0.471008),
        (0.54784, 0.531895, 0.471704),
        (0.609105, 0.579816, 0.463638),
        (0.671991, 0.629316, 0.448018),
        (0.736488, 0.680629, 0.424028),
        (0.802667, 0.733978, 0.390153),
        (0.870717, 0.789572, 0.343333),
        (0.941147, 0.84753, 0.275815),
        (0.995737, 0.909344, 0.217772),
    ),
}
_LUTS = {name: np.asarray(rows, dtype=np.float32) for name, rows in _LUT_ANCHORS.items()}


def apply_colormap(x: np.ndarray, name: str = "turbo") -> np.ndarray:
    """Map [H, W] floats in [0, 1] to [H, W, 3] via a named colormap."""
    if name == "gray":
        return np.repeat(np.clip(x, 0.0, 1.0)[..., None], 3, axis=-1)
    lut = _LUTS[name]
    n = lut.shape[0]
    t = np.clip(x, 0.0, 1.0) * (n - 1)
    i0 = np.floor(t).astype(np.int32)
    i1 = np.minimum(i0 + 1, n - 1)
    f = (t - i0)[..., None]
    return lut[i0] * (1.0 - f) + lut[i1] * f


def postprocess_depth(
    depth: np.ndarray, alpha: np.ndarray, state: RenderTabState
) -> np.ndarray:
    """Depth channel -> display RGB per the viewer state: optional near/far
    normalisation, optional inversion, then the colormap."""
    d = depth.astype(np.float32)
    if state.normalize_nearfar:
        lo, hi = state.near_plane, state.far_plane
    else:
        valid = alpha > 0.5
        lo = float(d[valid].min()) if valid.any() else 0.0
        hi = float(d[valid].max()) if valid.any() else 1.0
    d = (d - lo) / max(hi - lo, 1e-10)
    if state.inverse:
        d = 1.0 - d
    return apply_colormap(d, state.colormap)


def to_frame(img) -> np.ndarray:
    """A postprocessed render ([H, W, 3] or [H, W] floats in [0, 1], or
    uint8) as the uint8 [H, W, 3] frame the viewer sends."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


class _Server(ThreadingHTTPServer):
    """Answers HTTP 500 with the message of an exception that a request's
    handler raised before it began its answer."""

    daemon_threads = True

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self.answering = threading.local()  # a handler that began its answer

    def handle_error(self, request, client_address):
        if getattr(self.answering, "began", False):
            return
        body = str(sys.exc_info()[1]).encode()
        request.sendall(b"HTTP/1.0 500 Internal Server Error\r\nContent-Type: text/plain\r\n"
                        + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)


class GsplatViewer:
    """HTTP viewer server.

    `render_fn(camera_state, render_tab_state, img_wh) -> np.ndarray`
    returns either [H, W, 3] float RGB in [0, 1] (already postprocessed)
    or a dict with keys among {"rgb", "depth", "alpha"} for viewer-side
    postprocessing per `render_mode`.

    Parity: upstream gsplat's GsplatViewer + nerfview.Viewer's training-mode
    contract, as gsplat_tpu.viewer.GsplatViewer.
    """

    def __init__(
        self,
        render_fn: Callable,
        output_dir: str = ".",
        mode: str = "rendering",
        port: int = 8080,
        host: str = "0.0.0.0",
        state: Optional[RenderTabState] = None,
    ):
        assert mode in ("rendering", "training")
        self.render_fn = render_fn
        self.output_dir = output_dir
        self.mode = mode
        self.state = state or RenderTabState()
        self.lock = threading.Lock()
        self.step = 0
        self._steps_per_sec = 0.0
        self._last_update = time.perf_counter()
        self._last_step = 0

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, body, ctype):
                self.server.answering.began = True
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self.server.answering.began = False
                if self.path in ("/", "/index.html"):
                    from .page import HTML_PAGE

                    self._send(200, HTML_PAGE.encode(), "text/html")
                elif self.path == "/info":
                    info = viewer.state.to_dict()
                    info.update(
                        mode=viewer.mode,
                        step=viewer.step,
                        steps_per_sec=round(viewer._steps_per_sec, 2),
                        render_modes=list(RENDER_MODES),
                        colormaps=list(COLORMAPS),
                    )
                    self._send(200, json.dumps(info).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                self.server.answering.began = False
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/render":
                    # a failed render reaches the client as HTTP 500 with its
                    # message, through _Server.handle_error
                    self._send(200, viewer._handle_render(req), "image/png")
                elif self.path == "/state":
                    viewer.state.apply(req)
                    self._send(200, b"{}", "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

        self.server = _Server((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        print(f"gsplat_tpu_torch viewer: http://localhost:{self.port} (mode={mode})",
              flush=True)

    # -- trainer-facing API (nerfview contract) ---------------------------

    def update(self, step: int, num_train_rays_per_step: int = 0) -> None:
        """Called by the trainer each step; tracks rate and honours pause."""
        self.step = step
        now = time.perf_counter()
        if now - self._last_update > 2.0:
            self._steps_per_sec = (step - self._last_step) / (now - self._last_update)
            self._last_update = now
            self._last_step = step
        while self.state.paused:
            time.sleep(0.05)

    def complete(self) -> None:
        self.mode = "rendering"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    # -- internals --------------------------------------------------------

    def _handle_render(self, req: dict) -> bytes:
        """The PNG of a /render request's frame: its camera at its size
        (capped at `viewer_res` rows), rendered under `lock`, postprocessed
        per the state's render mode."""
        c2w = np.asarray(req["c2w"], dtype=np.float32).reshape(4, 4)
        fov = float(req.get("fov", 50.0 * np.pi / 180.0))
        w = int(req.get("width", 960))
        h = int(req.get("height", 540))
        max_h = max(int(self.state.viewer_res), 64)
        if h > max_h:
            w = int(round(w * max_h / h))
            h = max_h
        w, h = max(w, 16), max(h, 16)
        if req.get("state"):
            self.state.apply(req["state"])
        cam = CameraState(c2w=c2w, fov=fov, aspect=w / h)
        with self.lock:
            out = self.render_fn(cam, self.state, (w, h))
        if isinstance(out, dict):
            out = self._postprocess(out)
        return encode_png(to_frame(out), level=PNG_LEVEL)

    def _postprocess(self, out: dict) -> np.ndarray:
        st = self.state
        mode = st.render_mode
        if mode == "rgb":
            return out["rgb"]
        if mode == "alpha":
            return apply_colormap(np.asarray(out["alpha"])[..., 0], st.colormap)
        depth = np.asarray(out["depth"])[..., 0]
        alpha = np.asarray(out["alpha"])[..., 0]
        return postprocess_depth(depth, alpha, st)
