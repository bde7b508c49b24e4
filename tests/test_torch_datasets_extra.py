"""Port parity: the EndoNeRF and NCore readers, the resize and the 16-bit
PNGs they need without PIL, and the two trainers on them.

- 16-bit gray PNGs (EndoNeRF depth maps): PIL-written files decode to
  PIL's values, and the port's writer's files read back in PIL, every
  filter type, bit for bit.
- The resize (datasets/resize.py) against PIL 12: NEAREST equal, BILINEAR
  within 1 in uint8 (equal on these shapes, as it happens).
- EndoNeRF (the directory of tests/test_datasets.py, written through PIL):
  the parser's arrays and every item equal the JAX reader's; the dynamic
  trainer's EndoNeRF scene at factors 1 and 2 equals the JAX function's
  (the resize bit for bit); two steps of its runner from the JAX runner's
  start held to the JAX runner's (test_torch_dynamic.synced_steps: losses
  within 1e-4 relative, gradients in the trainer band).
- NCore on tests/test_datasets.py's in-memory `_FakeSource`: every parser
  field and dataset item equals the JAX reader's (pinhole, fisheye and
  f-theta cameras, time windows, rigid tracks, the normalised world).  On
  chip_smoke's street sequence at 96x64: ncore_scene equals the JAX
  function's; the AV runner's first step matches the JAX runner's loss
  (1e-4 relative) and gradients (2e-3 of each parameter's largest entry,
  floored at 1e-3 of the step's largest); and 12 steps lower the loss, as
  tests/test_datasets.py:496-513 asks.
"""

import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import av_trainer as jav  # noqa: E402
import dynamic_surgical_trainer as jdt  # noqa: E402
from datasets import endonerf as jendo  # noqa: E402
from datasets import ncore as jncore  # noqa: E402
from test_datasets import _FakeCamera, _FakeSource, _write_endonerf_dir  # noqa: E402
from test_torch_dynamic import jax_runner_start, synced_steps  # noqa: E402

import chip_smoke  # noqa: E402

from gsplat_tpu_torch import av_trainer as tav  # noqa: E402
from gsplat_tpu_torch import dynamic_trainer as tdt  # noqa: E402
from gsplat_tpu_torch.datasets import endonerf as tendo  # noqa: E402
from gsplat_tpu_torch.datasets import ncore as tncore  # noqa: E402
from gsplat_tpu_torch.datasets.colmap import decode_png_channels, encode_png  # noqa: E402
from gsplat_tpu_torch.datasets.resize import resize_bilinear_u8, resize_nearest  # noqa: E402


def test_sixteen_bit_gray_pngs_round_trip_with_pil():
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 65536, (23, 37)).astype(np.uint16)
    buf = io.BytesIO()
    Image.fromarray(depth).save(buf, "PNG")
    got = decode_png_channels(buf.getvalue())
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    for ftype in (0, 1, 2, 3, 4, None):
        data = encode_png(depth, ftype)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), depth)
        np.testing.assert_array_equal(decode_png_channels(data), depth)


@pytest.mark.parametrize("shape,size", [((512, 640), (160, 128)), ((48, 64), (32, 48)),
                                        ((37, 53), (31, 20)), ((30, 40), (80, 60)),
                                        ((33, 17), (50, 7)), ((1280, 1920), (960, 640))])
def test_resize_matches_pil(shape, size):
    rng = np.random.default_rng(shape[0])
    W, H = size
    for img in (rng.integers(0, 256, shape).astype(np.uint8),
                rng.integers(0, 256, shape + (3,)).astype(np.uint8)):
        want = np.asarray(Image.fromarray(img).resize((W, H), Image.BILINEAR)).astype(int)
        assert np.abs(resize_bilinear_u8(img, W, H).astype(int) - want).max() <= 1
        np.testing.assert_array_equal(resize_nearest(img, W, H),
                                      np.asarray(Image.fromarray(img).resize((W, H),
                                                                             Image.NEAREST)))
    depth = rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(resize_nearest(depth, W, H),
                                  np.asarray(Image.fromarray(depth).resize((W, H),
                                                                           Image.NEAREST)))


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(a):
        _same(dataclasses.asdict(a), dataclasses.asdict(b), what)
    else:
        assert a == b, (what, a, b)


def test_endonerf_reader_gives_the_jax_arrays(tmp_path):
    _write_endonerf_dir(tmp_path)
    j, t = jendo.EndoNeRFParser(str(tmp_path), test_every=4), tendo.EndoNeRFParser(
        str(tmp_path), test_every=4)
    for k in ("height", "width", "focal", "K", "bounds", "camtoworlds", "times", "train_idxs",
              "test_idxs", "video_idxs"):
        _same(getattr(t, k), getattr(j, k), k)
    for split in ("train", "test", "video"):
        jd, td = jendo.EndoNeRFDataset(j, split), tendo.EndoNeRFDataset(t, split)
        assert len(jd) == len(td)
        for i in range(len(td)):
            want, got = jd[i], td[i]
            assert got.keys() == want.keys()
            for k in want:
                _same(got[k], want[k], f"{split}[{i}].{k}")
    assert t.camtoworlds.dtype == np.float32 and td[0]["depth"].dtype == np.float32


def test_endonerf_reader_refuses_as_the_jax_reader(tmp_path):
    _write_endonerf_dir(tmp_path, bad_mask=True)
    with pytest.raises(ValueError, match="non-binary"):
        tendo.EndoNeRFParser(str(tmp_path))
    with pytest.raises(NotImplementedError):
        tendo.EndoNeRFParser(str(tmp_path), dataset_type="scared")


@pytest.mark.parametrize("factor", [1, 2])
def test_endonerf_scene_gives_the_jax_arrays(factor, tmp_path):
    _write_endonerf_dir(tmp_path, n=5)
    jcfg, tcfg = jdt.Config(cap=512), tdt.Config(cap=512)
    want = jdt.endonerf_scene(jcfg, str(tmp_path), factor=factor, max_frames=4)
    got = tdt.endonerf_scene(tcfg, str(tmp_path), factor=factor, max_frames=4)
    assert got.keys() == want.keys()
    for k in want:
        _same(got[k], want[k], k)
    assert (tcfg.W, tcfg.H, tcfg.n_times) == (jcfg.W, jcfg.H, jcfg.n_times)


def _write_textured_endonerf_dir(path, n=4, h=30, w=40, focal=40.0):
    """An EndoNeRF directory (through PIL) whose frames carry texture and
    whose depth varies, so that every parameter's gradient is well above
    rounding: smooth colour waves drifting with the frame, 16-bit depth
    between 2 and 3 (in thousandths), the tool in one corner."""
    poses = np.zeros((n, 3, 5))
    poses[:, :, 0], poses[:, :, 1], poses[:, :, 2] = [0, -1, 0], [1, 0, 0], [0, 0, 1]
    poses[:, :, 3] = [[0.01 * i, 0, 0] for i in range(n)]
    poses[:, :, 4] = [h, w, focal]
    np.save(path / "poses_bounds.npy",
            np.concatenate([poses.reshape(n, 15), np.tile([0.1, 5.0], (n, 1))], axis=1))
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    for sub in ("images", "depth", "masks"):
        (path / sub).mkdir()
    for i in range(n):
        rgb = np.stack([0.5 + 0.4 * np.sin(6 * xx + i), 0.5 + 0.4 * np.cos(5 * yy - i),
                        0.5 + 0.3 * np.sin(4 * (xx + yy))], -1)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(path / "images" / f"{i:06d}.png")
        depth = (2000 + 1000 * xx * yy + 50 * i).astype(np.uint16)
        Image.fromarray(depth).save(path / "depth" / f"{i:06d}.png")
        mask = np.zeros((h, w), np.uint8)
        mask[: h // 4, : w // 4] = 255
        Image.fromarray(mask).save(path / "masks" / f"{i:06d}.png")


def test_endonerf_steps_match_the_jax_runner(tmp_path):
    """The real-data regime (per-frame cameras, tissue masks in the loss):
    two steps from the JAX runner's start, losses and gradients against the
    JAX runner's."""
    _write_textured_endonerf_dir(tmp_path)
    cfg = tdt.Config(max_steps=2, cap=512)
    scene = tdt.endonerf_scene(cfg, str(tmp_path), factor=1, max_frames=4)
    hp, dp, thp, tdp = jax_runner_start(cfg)
    runner = tdt.DynamicRunner(cfg, scene, device="cpu", hex_params=thp, deform_params=tdp)
    assert runner.loss_masks is not None and float(runner.loss_masks.mean()) < 1
    losses = synced_steps(runner, (hp, dp), 2)
    assert all(np.isfinite(losses))


def _ncore_parsers(**kw):
    return jncore.NCoreParser(_FakeSource(), **kw), tncore.NCoreParser(_FakeSource(), **kw)


NCORE_FIELDS = ("sequence_id", "time_range_us", "camera_ids", "num_cameras",
                "T_world_to_scene_world", "Ks_dict", "imsize_dict", "mask_dict", "frame_list",
                "camera_idx_per_frame", "camtoworlds", "camtoworlds_end", "bounds", "points",
                "points_rgb", "scene_scale")


@pytest.mark.parametrize("kw", [
    dict(camera_ids=["front", "left"]),
    dict(camera_ids=["front"], seek_offset_sec=0.25, duration_sec=0.5, test_every=5),
    dict(camera_ids=["front"], rigid_dynamic_track_class_ids=["vehicle"], lidar_step_frame=2,
         max_lidar_points=700),
    dict(camera_ids=["front", "left"], normalize_world_space=True,
         rigid_dynamic_track_class_ids=["vehicle"]),
], ids=["two-cameras", "window", "tracks", "normalised"])
def test_ncore_reader_gives_the_jax_arrays(kw):
    j, t = _ncore_parsers(**kw)
    for k in NCORE_FIELDS + (("transform",) if kw.get("normalize_world_space") else ()):
        _same(getattr(t, k), getattr(j, k), k)
    for cid in t.camera_ids:
        _same(dataclasses.asdict(t.camera_render_data[cid]),
              dataclasses.asdict(j.camera_render_data[cid]), cid)
    assert len(t.rigid_dynamic_tracks) == len(j.rigid_dynamic_tracks)
    for a, b in zip(t.rigid_dynamic_tracks, j.rigid_dynamic_tracks):
        _same(dataclasses.asdict(a), dataclasses.asdict(b), a.track_id)
    for split in ("train", "val"):
        jd, td = jncore.NCoreDataset(j, split), tncore.NCoreDataset(t, split)
        assert len(td) == len(jd)
        for i in range(len(td)):
            want, got = jd[i], td[i]
            assert got.keys() == want.keys()
            for k in want:
                _same(got[k], want[k], f"{split}[{i}].{k}")


def test_ncore_ftheta_record_and_resized_frames_match_jax():
    """An f-theta camera (its record is the port's sensors.params one), and a
    camera whose frames and masks come at twice the calibrated size, which
    the datasets resize (PIL's BILINEAR and NEAREST there)."""
    ft = dict(width=64, height=48, cx=32.0, cy=24.0, reference_poly="pixeldist_to_angle",
              pixeldist_to_angle_poly=(0.0, 0.02, 0.0, 0.0, 0.0, 0.0),
              angle_to_pixeldist_poly=(0.0, 50.0, 0.0, 0.0, 0.0, 0.0), max_angle=1.8)

    class BigFrames(_FakeCamera):
        def image(self, frame_idx):
            rng = np.random.default_rng(frame_idx)
            return rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)

        def frame_mask(self, frame_idx):
            return np.random.default_rng(frame_idx + 50).random((96, 128)) > 0.2

    for make in (jncore, tncore):
        cams = {"fish": _FakeCamera(make.FThetaParams(**ft), offset=(0, 0, 1.5)),
                "big": BigFrames(make.PinholeParams(width=64, height=48, fx=60.0, fy=60.0,
                                                    cx=32.0, cy=24.0), offset=(0, 1, 1.5))}
        p = make.NCoreParser(_FakeSource(cameras=cams), camera_ids=["fish", "big"])
        items = [make.NCoreDataset(p, "train")[i] for i in range(4)]
        if make is jncore:
            want_p, want_items = p, items
    rd, jrd = p.camera_render_data["fish"], want_p.camera_render_data["fish"]
    assert rd.camera_model == jrd.camera_model == "ftheta"
    for f in ("reference_poly", "pixeldist_to_angle_poly", "angle_to_pixeldist_poly",
              "max_angle", "linear_cde"):
        assert getattr(rd.ftheta_coeffs, f) == getattr(jrd.ftheta_coeffs, f), f
    _same(p.Ks_dict, want_p.Ks_dict, "Ks")
    for got, want in zip(items, want_items):
        for k in want:
            if k == "image":  # PIL's BILINEAR, within 1 in uint8
                assert np.abs(got[k] - want[k]).max() <= 1 / 255 + 1e-7
            else:
                _same(got[k], want[k], k)


def test_ncore_parser_refuses_a_path():
    with pytest.raises(NotImplementedError, match="SDK adapter"):
        tncore.NCoreParser("/no/such/meta.json")


def _street(kind):
    """chip_smoke's in-memory street sequence at 96x64 (3 training frames,
    3,000 lidar points), its camera record of `kind`'s classes."""
    seq = chip_smoke.StreetSequence((96, 64), 4, 3000)
    seq._cam.params = kind.PinholeParams(**dataclasses.asdict(seq._cam.params))
    return seq


NCORE_SCENE = dict(camera_ids=["front"], max_frames=3, max_points=3000)
# the points' spacing, as chip_smoke's NCore phase starts them (the runner's
# own start, 0.3x the distance to a random other point, is a third of the scene)
STREET_SCALE = float(np.log(0.5 * np.sqrt(60 * 26 / 1500)))


def test_ncore_scene_and_the_first_av_step_match_jax(tmp_path):
    """ncore_scene on the street sequence equals the JAX function's, and the
    AV runner's first step on it (photometric, masked) matches the JAX
    runner's loss and gradients."""
    want = jav.ncore_scene(_street(jncore), **NCORE_SCENE)
    got = tav.ncore_scene(_street(tncore), **NCORE_SCENE)
    assert got.keys() == want.keys() and got["lidar"] is None and got["masks"] is not None
    for k in want:
        if k != "parser":
            _same(got[k], want[k], k)

    kw = dict(data="ncore", max_steps=1, cap_max=3072, isect_capacity=1 << 16,
              result_dir=str(tmp_path))
    jr, tr = jav.AVRunner(jav.Config(**kw), want), tav.AVRunner(tav.Config(**kw), got,
                                                                device="cpu")
    jr.params["scales"] = jnp.full_like(jr.params["scales"], STREET_SCALE)
    tr.params["scales"].fill_(STREET_SCALE)
    cams, Ks = jnp.asarray(want["viewmats"]), jnp.asarray(want["Ks"])
    gt, mask = jnp.asarray(want["images"]), jnp.asarray(want["masks"])[..., None].astype(
        jnp.float32)
    cfg = jr.cfg

    def loss_fn(p):  # AVRunner.train's loss without a lidar (examples/av_trainer.py:276-283)
        colors, _, meta = jr.render_cams(p, jr.alive, cams, Ks)
        colors = jnp.clip(colors, 0.0, 1.0) * mask
        return (jav.l1_loss(colors, gt * mask) * (1 - cfg.ssim_lambda)
                + jav.ssim_loss(colors, gt * mask) * cfg.ssim_lambda), meta["n_isects"]

    (jl, n_isects), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jr.params)
    inputs = tr.prepare()
    assert inputs["lvm"] is None and inputs["pix_mask"] is not None
    leaves = {k: v.clone().requires_grad_() for k, v in tr.params.items()}
    loss, meta, lmeta = tr.loss_fn(leaves, tr.alive, **inputs)
    assert lmeta is None and int(meta["n_isects"]) == int(n_isects) > 1000
    assert not bool(meta["isect_overflow"])
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k, g in jg.items():
        w = np.asarray(g)
        np.testing.assert_allclose(leaves[k].grad.numpy(), w, rtol=0,
                                   atol=2e-3 * max(float(np.abs(w).max()), floor), err_msg=k)


@pytest.fixture
def one_torch_thread():
    """Twelve CPU steps in one thread: beside the suite's other workers, a
    process's full thread pool slowed them twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ncore_scene_trains_and_the_loss_falls(tmp_path, one_torch_thread):
    """tests/test_datasets.py:496-513 on the port, photometric only, 12
    steps; on the street sequence, whose camera sees its lidar's points (the
    fake source's camera faces away from its points, so its loss cannot
    move)."""
    scene = tav.ncore_scene(_street(tncore), **NCORE_SCENE)
    assert scene["images"].shape[0] == 3 and scene["viewmats"].shape == (3, 4, 4)
    cfg = tav.Config(data="ncore", max_steps=12, cap_max=3072, isect_capacity=1 << 16,
                     result_dir=str(tmp_path))
    runner = tav.AVRunner(cfg, scene, device="cpu")
    runner.params["scales"].fill_(STREET_SCALE)
    losses = runner.train(log=lambda m: None)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
