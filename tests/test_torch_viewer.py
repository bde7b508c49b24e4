"""Port parity: the viewer (gsplat_tpu_torch.viewer) against gsplat_tpu.viewer.

The colormaps (the port's inline anchors against the JAX viewer's reads of
matplotlib) and the depth display within 1e-6; the state and camera
objects equal; `make_render_fn` in the four render modes against the JAX
one on tests/test_torch_rendering.py's 120-gaussian scene at 64x48, in
that file's band (scaled by the depth for the depth channel); the HTTP contract of tests/test_viewer.py (the
endpoints, `viewer_res` capping, the pause contract) with each PNG frame
decoded and equal, byte for byte, to the frame rendered in-process; a
failing `render_fn` answers HTTP 500 with its message; the trainer with
`disable_viewer=False` serves a frame between steps and honours a pause.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import gsplat_tpu.viewer as jv  # noqa: E402
from test_torch_rendering import _band_close, _scene  # noqa: E402
from test_torch_trainer import _cfg_kw, _tiny_data  # noqa: E402

import gsplat_tpu_torch.viewer as tv  # noqa: E402
from gsplat_tpu_torch.datasets import decode_png_channels  # noqa: E402
from gsplat_tpu_torch.trainer import Config, Trainer  # noqa: E402
from gsplat_tpu_torch.viewer.core import to_frame  # noqa: E402

W, H = 64, 48
FOV = 1.0


def test_render_modes_and_colormaps_equal_the_jax_viewers():
    assert tv.RENDER_MODES == jv.RENDER_MODES and tv.COLORMAPS == jv.COLORMAPS


@pytest.mark.parametrize("name", jv.COLORMAPS)
def test_colormaps_match_jax(name):
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (7, 9)).astype(np.float32)
    x[0, :3] = (0.0, 0.5, 1.0)
    got, want = tv.apply_colormap(x, name), jv.apply_colormap(x, name)
    assert got.dtype == want.dtype and got.shape == want.shape == (7, 9, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalize_nearfar, inverse",
                         [(False, False), (False, True), (True, False), (True, True)])
def test_postprocess_depth_matches_jax(normalize_nearfar, inverse):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 6.0, (8, 10)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, (8, 10)).astype(np.float32)
    kw = dict(normalize_nearfar=normalize_nearfar, inverse=inverse, near_plane=0.4,
              far_plane=7.0, colormap="magma")
    got = tv.postprocess_depth(depth, alpha, tv.RenderTabState(**kw))
    want = jv.postprocess_depth(depth, alpha, jv.RenderTabState(**kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_render_tab_state_and_camera_match_jax():
    upd = {"render_mode": "depth(expected)", "colormap": "viridis", "near_plane": "0.5",
           "max_sh_degree": 2.0, "backgrounds": [0.1, 0.2, 0.3], "inverse": 1,
           "total_gs_count": 99, "unknown": 3, "paused": True}
    t, j = tv.RenderTabState(total_gs_count=7), jv.RenderTabState(total_gs_count=7)
    assert t.to_dict() == j.to_dict()
    t.apply(upd)
    j.apply(upd)
    assert t.to_dict() == j.to_dict() and t.total_gs_count == 7
    c2w = np.eye(4, dtype=np.float32)
    np.testing.assert_array_equal(tv.CameraState(c2w, 0.9, 4 / 3).get_K((W, H)),
                                  jv.CameraState(c2w, 0.9, 4 / 3).get_K((W, H)))


@pytest.fixture(scope="module")
def scenes():
    """The 120-gaussian SH-3 scene as the port's tensors and as JAX arrays,
    and a camera-to-world matrix of one of its views."""
    means, quats, scales, opac, coeffs, viewmats, _ = _scene()
    arrays = dict(means=means, quats=quats, scales=scales, opacities=opac, colors=coeffs)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    for d in (t, j):
        d.update(sh_degree=3, n_rendered=120)
    return t, j, np.linalg.inv(viewmats[0])


@pytest.fixture(scope="module")
def jax_render_fn(scenes):
    """One JAX render_fn for every mode: its jit cache keys on the size, the
    SH degree and the rasterization mode (rgb and alpha share one)."""
    return jv.make_render_fn(lambda: scenes[1], isect_capacity=8192)


@pytest.mark.parametrize("mode", jv.RENDER_MODES)
def test_make_render_fn_matches_jax(scenes, jax_render_fn, mode):
    t_scene, _, c2w = scenes
    t_st = tv.RenderTabState(render_mode=mode, max_sh_degree=2, backgrounds=(0.2, 0.1, 0.0),
                             near_plane=0.05, far_plane=50.0)
    j_st = jv.RenderTabState(**{k: getattr(t_st, k) for k in ("render_mode", "max_sh_degree",
                                                              "backgrounds", "near_plane",
                                                              "far_plane")})
    wh = (W + 5, H + 9)  # both round down to multiples of 16
    got = tv.make_render_fn(lambda: t_scene, isect_capacity=8192)(
        tv.CameraState(c2w, FOV, W / H), t_st, wh)
    want = jax_render_fn(jv.CameraState(c2w, FOV, W / H), j_st, wh)
    assert t_st.rendered_gs_count == j_st.rendered_gs_count == 120
    if mode == "rgb":
        got, want = {"rgb": got}, {"rgb": want}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape and got[k].shape[:2] == (H, W)
        # the depth channel is in scene units (~3): the band scaled by the
        # depth, as tests/test_torch_rendering.py scales it
        scale = 4.0 if k == "depth" else 1.0
        _band_close(got[k] / scale, np.asarray(want[k]) / scale, f"{mode}: {k}")


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=30)


def _render_request(c2w, w=W, h=H):
    return {"c2w": np.asarray(c2w).ravel().tolist(), "fov": FOV, "width": w, "height": h}


@pytest.fixture()
def viewer(scenes):
    v = tv.GsplatViewer(tv.make_render_fn(lambda: scenes[0], isect_capacity=8192),
                        mode="rendering", port=0)
    yield v
    v.close()


def test_info_and_index_endpoints(viewer):
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/info", timeout=10) as r:
        info = json.loads(r.read())
    for key in ("max_sh_degree", "near_plane", "far_plane", "radius_clip", "eps2d",
                "backgrounds", "render_mode", "normalize_nearfar", "inverse", "colormap",
                "rasterize_mode", "camera_model", "mode", "step", "steps_per_sec"):
        assert key in info, key
    assert info["render_modes"] == list(jv.RENDER_MODES)
    assert info["colormaps"] == list(jv.COLORMAPS)
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/", timeout=10) as r:
        page = r.read().decode()
    assert "gsplat_tpu_torch viewer" in page and "/render" in page
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/nothing", timeout=10)
    assert e.value.code == 404


@pytest.mark.parametrize("mode", jv.RENDER_MODES)
def test_render_frames_decode_to_the_in_process_frame(viewer, scenes, mode):
    """/state sets the mode; the /render answer is a PNG whose pixels equal
    make_render_fn's render, postprocessed, byte for byte."""
    _post(viewer.port, "/state", {"render_mode": mode, "colormap": "viridis"}).read()
    assert viewer.state.render_mode == mode and viewer.state.colormap == "viridis"
    with _post(viewer.port, "/render", _render_request(scenes[2], W + 3, H)) as r:
        assert r.headers["Content-Type"] == "image/png"
        data = r.read()
    got = decode_png_channels(data)
    out = viewer.render_fn(tv.CameraState(np.asarray(scenes[2], np.float32), FOV, W / H),
                           viewer.state, (W + 3, H))
    want = to_frame(viewer._postprocess(out) if isinstance(out, dict) else out)
    assert got.shape == want.shape == (H, W, 3) and want.max() > 0
    np.testing.assert_array_equal(got, want)


def test_viewer_res_caps_render(viewer, scenes):
    viewer.state.viewer_res = 64
    with _post(viewer.port, "/render", _render_request(scenes[2], 1920, 1080)) as r:
        img = decode_png_channels(r.read())
    assert img.shape == (64, 112, 3)  # 1920 x 1080 scaled to 64 rows, then to 16s


def test_a_failing_render_answers_500_with_its_message():
    def broken(cam, state, img_wh):
        raise RuntimeError("the render failed here")

    v = tv.GsplatViewer(broken, port=0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(v.port, "/render", _render_request(np.eye(4)))
    assert e.value.code == 500 and e.value.read() == b"the render failed here"
    assert not v.lock.locked()
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}/info", timeout=10) as r:
        assert json.loads(r.read())["mode"] == "rendering"  # the server serves on
    v.close()


def test_training_pause_contract():
    v = tv.GsplatViewer(lambda cam, st, wh: np.zeros((wh[1], wh[0], 3)), mode="training",
                        port=0)
    steps = []

    def trainer():
        for i in range(200):
            with v.lock:
                steps.append(i)
            v.update(i)

    t = threading.Thread(target=trainer)
    v.state.paused = True
    t.start()
    time.sleep(0.3)
    assert len(steps) <= 2  # paused almost immediately
    v.state.paused = False
    t.join(timeout=5)
    assert not t.is_alive() and len(steps) == 200 and v.step == 199
    v.close()


def test_trainer_serves_a_frame_between_steps_and_honours_a_pause(tmp_path):
    """Config(disable_viewer=False, viewer_port=0): after step 1 a frame of
    the step-0 snapshot arrives over HTTP, then a pause holds the loop until
    a resume; after training the frame shows the final parameters."""
    cfg = Config(**_cfg_kw(tmp_path / "run", max_steps=4, eval_every=100, save_every=100,
                           tb_every=0, disable_viewer=False, viewer_port=0))
    tr = Trainer(cfg, data=_tiny_data(), device="cpu")
    c2w = np.linalg.inv(tr.viewmats[0])
    run_step, seen = tr.run_step, {}

    def recording_step(step, *a):
        out = run_step(step, *a)
        seen[step] = time.perf_counter()
        if step == 1:
            with _post(tr.viewer.port, "/render", _render_request(c2w)) as r:
                seen["frame"] = decode_png_channels(r.read())
            _post(tr.viewer.port, "/state", {"paused": True}).read()

            def resume():
                time.sleep(0.5)
                seen["steps_while_paused"] = max(k for k in seen if isinstance(k, int))
                _post(tr.viewer.port, "/state", {"paused": False}).read()

            threading.Thread(target=resume).start()
        return out

    tr.run_step = recording_step
    tr.train()
    v = tr.viewer
    assert seen["frame"].shape == (H, W, 3) and seen["frame"].max() > 0
    assert seen["steps_while_paused"] == 1 and seen[2] - seen[1] >= 0.5
    assert v.mode == "rendering" and v.step == 3 and not v.state.paused
    with _post(v.port, "/render", _render_request(c2w)) as r:
        got = decode_png_channels(r.read())
    snap = v.render_fn(tv.CameraState(c2w.astype(np.float32), FOV, W / H), v.state, (W, H))
    np.testing.assert_array_equal(got, to_frame(snap))
    assert torch.equal(tr._snapshot["params"]["means"], tr.params["means"])
    v.close()


def test_frames_never_mix_two_snapshots_under_concurrent_requests():
    """The trainer's contract, stressed: a writer swaps the scene under
    `viewer.lock` while 12 clients request frames at once, with a short
    switch interval; each frame comes from one snapshot (both halves of its
    image carry the same generation)."""
    snapshot = {"left": 0, "right": 0}

    def render(cam, st, wh):
        left = snapshot["left"]
        time.sleep(0.001)  # a frame takes a while: a swap could land here
        right = snapshot["right"]
        img = np.zeros((wh[1], wh[0], 3), np.uint8)
        img[:, : wh[0] // 2] = left % 256
        img[:, wh[0] // 2:] = right % 256
        return img

    v = tv.GsplatViewer(render, mode="training", port=0)
    stop, frames, errors = threading.Event(), [], []

    def writer():
        gen = 0
        while not stop.is_set():
            gen += 1
            with v.lock:
                snapshot["left"] = gen
                time.sleep(0.0005)
                snapshot["right"] = gen

    def client():
        for _ in range(6):
            with _post(v.port, "/render", _render_request(np.eye(4), 32, 16)) as r:
                img = decode_png_channels(r.read())
            frames.append(img)
            if img[0, 0, 0] != img[0, -1, 0]:
                errors.append((int(img[0, 0, 0]), int(img[0, -1, 0])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    w = threading.Thread(target=writer)
    clients = [threading.Thread(target=client) for _ in range(12)]
    try:
        w.start()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        stop.set()
        w.join(timeout=10)
        sys.setswitchinterval(old)
        v.close()
    assert not w.is_alive() and not any(c.is_alive() for c in clients)
    assert len(frames) == 72 and not errors
