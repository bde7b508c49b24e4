"""Drive the PyTorch port's serving path on one NVIDIA card and hold each
CUDA kernel against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card's name and power limit (nvidia-smi), build the kernels
     from csrc/ (one nvcc per source, in parallel) and print the seconds;
  2. serving: a synthetic scene of the benchmark's size (2,794,625
     gaussians, SH degree 3, 25 grid cells of 111,785 points, made from a
     fixed seed) goes through splats_from_numpy -> GaussianScene ->
     GaussianInferenceScene -> Stage and renders 4 look-at requests at
     3840x2160 (tile 16, fast=False) after one sizing/warm-up pass.  Every
     kernel's launch count is set to 0 just before the 4 requests and read
     just after; each must be > 0;
  3. reference: a small crop of the scene renders on the card and on the
     CPU (plain versions) and the images must agree (band tolerance);
  4. kernels: the rasterizer's stages rerun on request 0's camera and must
     give request 0's image bit for bit; K3 and K4 against their plain
     versions on those inputs (exact), K1 against its plain version at the
     serving shape and at 960x540 with tiles 8, 16 and 32 (max |d| <= 1e-4),
     and each kernel timed at the serving shape with CUDA events;
  5. profile: each stage of a request timed alone, and a torch.profiler
     trace of 3 requests giving device time by kernel and the device's
     busy and idle share.
It prints one `kernels` JSON line and, last, the `ok` JSON line; any
failure exits non-zero without it.  The script never falls back to the CPU.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.ops import gather_kernel as gk
from gsplat_tpu_torch.ops import rasterize as rz
from gsplat_tpu_torch.ops import rasterize_kernel as rk
from gsplat_tpu_torch.ops.projection import fully_fused_projection
from gsplat_tpu_torch.ops.sh import spherical_harmonics
from gsplat_tpu_torch.rendering import _campos_from_viewmats
from gsplat_tpu_torch.scene import GaussianInferenceScene, Stage, render_scene, splats_from_numpy

SEED = 0
N_CELL, GRID = 111_785, 5  # 25 cells: 2,794,625 gaussians
SERVE_WH = (3840, 2160)
CHECK_WH = (960, 540)
N_VIEWS = 4
TILE = 16
RENDER_KW = dict(near_plane=0.01, far_plane=100.0, radius_clip=3.0, tile_size=TILE)
SH_C0 = 0.28209479177387814
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
K1_FLOP_PER_PAIR = 21  # ~20 f32 operations and one exp per (pixel, slot)
KERNELS = {
    "expand_rows": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:396"),
    "expand_emission": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:584"),
    "rasterize_fwd": ("csrc/rasterize_fwd.cu", "gsplat_tpu/ops/rasterize_pallas.py:330"),
}
WRAPPERS = {"expand_rows": gk.expand_rows, "expand_emission": gk.expand_emission,
            "rasterize_fwd": rk.rasterize_fwd}


class Fail(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Fail(what)


def make_splats(n_cell: int, grid: int, seed: int):
    """Raw trainer-layout parameters of the synthetic scene: points uniform
    in the [-2, 2]^3 crop, replicated over a grid x grid layout of cells
    4 units apart; scales in [1e-4, 0.02], random unit quats and uniform
    opacities, drawn as gsplat_tpu/utils/data.py does; SH degree 3 with sh0
    from random colors and small random higher bands."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (n_cell, 3)).astype(np.float32)
    colors = rng.random((n_cell, 3)).astype(np.float32)
    r = np.arange(-(grid // 2), grid // 2 + 1)
    gx, gy = np.meshgrid(r, r, indexing="ij")
    offsets = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3) * 4.0
    means = (base[None] + offsets[:, None].astype(np.float32)).reshape(-1, 3)
    colors = np.tile(colors, (grid * grid, 1))
    N = len(means)
    scales = (rng.random((N, 3)) * (0.02 - 1e-4) + 1e-4).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = np.clip(rng.random((N,)), 1e-4, 1 - 1e-4).astype(np.float32)
    return {
        "means": means,
        "quats": quats,
        "scales": np.log(scales),
        "opacities": np.log(opac / (1.0 - opac)),
        "sh0": ((colors - 0.5) / SH_C0)[:, None, :],
        "shN": (rng.standard_normal((N, 15, 3)) * 0.05).astype(np.float32),
    }


def look_at_cameras(means: np.ndarray, n_views: int, W: int, H: int, fov_deg: float = 60.0):
    """An orbit of look-at cameras around the scene's median, as
    examples/sample_inference.py:orbit_cameras places them."""
    center = np.median(means, axis=0)
    radius = 1.5 * float(np.percentile(np.linalg.norm(means - center, axis=1), 70))
    f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = center + np.array([radius * math.cos(a), radius * math.sin(a), -0.3 * radius])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, -1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ eye
        views.append(w2c)
    return np.stack(views), K


def scaled_K(K: np.ndarray, s: float) -> np.ndarray:
    K = K.copy()
    K[:2] *= s
    return K


def rasterizer_inputs(scene: GaussianInferenceScene, vm: np.ndarray, K: np.ndarray, W: int, H: int):
    """The inputs that rasterization() hands rasterize_to_pixels for one
    request: projection, SH colors (clamped at 0 after +0.5), opacities."""
    dev = scene.get("means").device
    f32 = lambda name: scene.get(name).to(torch.float32)
    means, opac = f32("means"), f32("opacities")
    vm_t = torch.as_tensor(vm, device=dev)[None]
    radii, m2, depths, conics, _ = fully_fused_projection(
        means, None, f32("quats"), f32("scales"), vm_t, torch.as_tensor(K, device=dev)[None],
        W, H, near_plane=RENDER_KW["near_plane"], far_plane=RENDER_KW["far_plane"],
        radius_clip=RENDER_KW["radius_clip"], opacities=opac,
    )
    dirs = means[None] - _campos_from_viewmats(vm_t)[:, None, :]
    colors = spherical_harmonics(scene.sh_degree, dirs, f32("colors"),
                                 masks=(radii > 0).all(dim=-1))
    return dict(means2d=m2, conics=conics, colors=torch.clamp(colors + 0.5, min=0.0),
                opacities=opac[None], radii=radii, depths=depths)


def forward_stages(scene: GaussianInferenceScene, vm, K, W: int, H: int, ts: int, cap: int,
                   row_cap: int):
    """One request's rasterizer forward, split into the named stages that
    rendering.rasterization and ops/rasterize.py:rasterize_to_pixels run.
    The stages share one state dict; run in order, they leave each
    kernel's arguments in it ("k4", "k1", and "plan_args" for K3) and the
    composite's output in "out".  The profile phase times each alone."""
    tw, th = -(-W // ts), -(-H // ts)
    T = tw * th
    st = {}

    def inputs():
        st["inp"] = rasterizer_inputs(scene, vm, K, W, H)

    def compact():
        i = st["inp"]
        st["comp"] = rz.compact_by_depth(i["means2d"], i["conics"], i["colors"], i["opacities"],
                                         i["radii"], i["depths"])

    def plan():
        c = st["comp"]
        st["plan_args"] = (c.means2d, c.radii, c.conics, c.opacities, c.image_ids, c.n_live,
                           1, ts, tw, th)
        st["plan"] = rz.make_tight_plan(*st["plan_args"], cap, row_cap)

    def table():
        st["table"] = rz.field_table(st["comp"], st["plan"].dummy)

    def emit():
        p = st["plan"]
        st["k4"] = (p.rr, st["table"], p.n_slots, cap, tw, T, T)
        st["emitted"] = gk.expand_emission(*st["k4"])

    def sort():
        st["k1"] = (*rz.sort_slots(*st["emitted"], T), 1, ts, tw, th, W, H)

    def composite():
        st["out"] = rk.rasterize_fwd(*st["k1"])

    return st, [("projection + SH", inputs), ("compaction sort", compact),
                ("tight plan (incl. K3)", plan), ("field table", table),
                ("emission K4", emit), ("slot sort + spans", sort), ("composite K1", composite)]


def kernel_inputs(scene, vm, K, W: int, H: int, ts: int, cap: int, row_cap: int):
    """Run the forward stages once; keep each kernel's arguments and output."""
    st, stages = forward_stages(scene, vm, K, W, H, ts, cap, row_cap)
    for _, fn in stages:
        fn()
    plan = st["plan"]
    require(not bool(plan.overflow), f"kernel inputs overflow at {W}x{H} tile {ts}")
    geo = rz.row_geometry(*st["plan_args"], row_cap)
    return dict(
        inp=st["inp"], k3=(geo.gg_f, geo.gg_i, geo.n_rows, row_cap, ts, 1), k4=st["k4"],
        k1=st["k1"], out=st["out"], n_live=int(st["comp"].n_live), n_rows=int(geo.n_rows[0]),
        n_slots=int(plan.n_slots[0]), n_isects=int(plan.n_isects),
    )


def evaluated_pairs(fields, bounds, n_images, tile, tiles_w, tiles_h, width, height) -> int:
    """(pixel, slot) pairs K1 evaluates on its arguments: each in-image pixel
    reads its tile's slots up to and including the one that stops it.  The
    work count behind K1's bound, from the plain composite's batches."""
    starts = bounds[:-1].long()
    counts = (bounds[1:] - bounds[:-1]).long()
    total = 0
    for t0, t1, L in rk._tile_batches(counts[: n_images * tiles_w * tiles_h], tile * tile):
        _, _, _, ev, (_, _, _, inside) = rk._composite_batch(
            fields, starts, counts, t0, t1, L, tile, tiles_w, tiles_w * tiles_h, width, height
        )
        total += int((ev * inside).sum())
    return total


def band_close(a: torch.Tensor, b: torch.Tensor, name: str, strict=3e-5, frac=0.05, hard=2e-4):
    diff = (a.double() - b.double()).abs()
    bad = float((diff > strict).double().mean())
    worst = float(diff.max())
    require(bad < frac and worst < hard, f"{name}: {bad:.4f} of values over {strict}, max {worst}")
    return worst


def cuda_timer(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Serving:
    """The synthetic scene registered on a Stage, and its request cameras."""

    def __init__(self, dev: torch.device, n_cell: int, grid: int, serve_wh):
        self.raw = make_splats(n_cell, grid, SEED)
        self.gscene = splats_from_numpy(self.raw, device=dev, scene_id="synthetic_grid5")
        self.scene = GaussianInferenceScene.from_gaussian_scene(self.gscene, id=self.gscene.id)
        self.stage = Stage()
        self.stage.add_scene(
            self.gscene, lambda splats, alive=None, **kw: render_scene(self.scene, **kw)
        )
        self.W, self.H = serve_wh
        self.viewmats, self.K = look_at_cameras(self.raw["means"], N_VIEWS, *serve_wh)
        self.cap = self.row_cap = 4 * self.scene.num_gaussians

    def request(self, vm):
        return self.stage.render(
            self.gscene.id, viewmat=vm, K=self.K, width=self.W, height=self.H, fast=False,
            isect_capacity=self.cap, row_capacity=self.row_cap, **RENDER_KW,
        )

    def size_capacities(self):
        """Warm up on every view and size the capacities so nothing
        overflows: the AABB tile counts bound each gaussian's tight slots,
        each visible gaussian adds at most one dummy slot, and row records
        never outnumber slots."""
        bound = 0
        for vm in self.viewmats:
            _, _, meta = self.request(vm)
            n_vis = int((meta["radii"] > 0).all(dim=-1).sum())
            if bool(meta["isect_overflow"]):
                bound = max(bound, int(meta["tiles_per_gauss"].sum()) + n_vis)
            else:
                bound = max(bound, int(meta["n_isects"]) + n_vis)
        self.cap = self.row_cap = bound + 4096
        for vm in self.viewmats:  # warm the sized shapes
            self.request(vm)


def run(dev: torch.device, n_cell: int, grid: int, serve_wh, check_wh, timer, log=print):
    """All phases on `dev`; returns the serving records and the `kernels` records."""
    t0 = time.perf_counter()
    sv = Serving(dev, n_cell, grid, serve_wh)
    raw, scene, viewmats, K = sv.raw, sv.scene, sv.viewmats, sv.K
    W, H = serve_wh
    log(f"scene: {scene.num_gaussians} gaussians, SH degree {scene.sh_degree}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    sv.size_capacities()
    cap, row_cap = sv.cap, sv.row_cap
    log(f"capacities: isect {cap}, rows {row_cap}")

    # Serving: the counts are read right after the 4 requests.
    for w in WRAPPERS.values():
        w.launches = 0
    serve = []
    for i, vm in enumerate(viewmats):
        if dev.type == "cuda":
            torch.cuda.synchronize()  # no earlier work may land in this request's time
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        img, alpha, meta = sv.request(vm)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        rec = dict(request=i, ms=ms, n_isects=int(meta["n_isects"]), peak_gib=peak,
                   mean_alpha=float(alpha.mean()), overflow=bool(meta["isect_overflow"]))
        serve.append(rec)
        if i == 0:  # for the kernel phase's checks, kept on the host
            req0 = {k: meta[k].cpu() for k in ("radii", "means2d", "conics", "depths")}
            req0.update(img=img.cpu(), alpha=alpha.cpu())
        log("serve " + json.dumps(rec))
        require(img.shape == (1, H, W, 3) and alpha.shape == (1, H, W, 1), "image shape")
        require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(alpha).all()),
                f"request {i}: non-finite image")
        require(not rec["overflow"], f"request {i}: isect_overflow")
        require(rec["mean_alpha"] > 0, f"request {i}: empty image")
        del img, alpha, meta  # the next request's peak holds nothing of this one
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    log("serving launches " + json.dumps(launches))
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the serving path")

    # Reference: a small crop renders on this device and on the CPU alike.
    sub = {k: v[: max(n_cell // 8, 1)] for k, v in raw.items()}
    ref_wh = (check_wh[0] // 2, check_wh[1] // 2)
    vm_ref, K_ref = look_at_cameras(sub["means"], 1, *ref_wh)
    outs = []
    for d in (dev, torch.device("cpu")):
        s = GaussianInferenceScene.from_gaussian_scene(splats_from_numpy(sub, device=d), id="crop")
        c, a, _ = render_scene(s, viewmat=vm_ref[0], K=K_ref, width=ref_wh[0], height=ref_wh[1],
                               fast=False, isect_capacity=4 * len(sub["means"]), **RENDER_KW)
        outs.append((c.cpu(), a.cpu()))
    band_close(outs[0][0], outs[1][0], "reference colors")
    band_close(outs[0][1], outs[1][1], "reference alphas")
    require(float(outs[1][1].mean()) > 0, "reference image is empty")
    log(f"reference: {len(sub['means'])} gaussians at {ref_wh[0]}x{ref_wh[1]} agree with the CPU")

    # Kernels against their plain versions, on request 0's own inputs: the
    # stages rerun on its camera must give its projection, plan and image.
    serve_in = kernel_inputs(scene, viewmats[0], K, W, H, TILE, cap, row_cap)
    for key in ("radii", "means2d", "conics", "depths"):
        require(torch.equal(serve_in["inp"][key].cpu(), req0[key]),
                f"recomputed {key} differ from request 0")
    require(serve_in["n_isects"] == serve[0]["n_isects"], "recomputed n_isects differ")
    got_c, got_t = (x.cpu() for x in serve_in["out"])
    require(torch.equal(got_c, req0["img"]) and torch.equal((1.0 - got_t)[..., None], req0["alpha"]),
            "the stages rerun on request 0's camera do not give its image")
    err = {}
    got = gk.expand_rows(*serve_in["k3"])
    want = gk.expand_rows_plain(*serve_in["k3"])
    require(all(torch.equal(x, y) for x, y in zip(got, want)), "expand_rows != plain")
    err["expand_rows"] = 0.0
    got = gk.expand_emission(*serve_in["k4"])
    want = gk.expand_emission_plain(*serve_in["k4"])
    require(all(torch.equal(x, y) for x, y in zip(got, want)), "expand_emission != plain")
    err["expand_emission"] = 0.0

    def k1_err(ci, what):
        want = rk.rasterize_fwd_plain(*ci["k1"])
        e = max(float((x - y).abs().max()) for x, y in zip(ci["out"], want))
        log(f"rasterize_fwd {what}: max |d| {e:.3g}, {ci['n_slots']} slots")
        # exp ulps and the order of the colour sums differ: 1e-4 absolute
        require(e <= 1e-4, f"rasterize_fwd {what}: max |d| {e} > 1e-4")
        return e

    err["rasterize_fwd"] = k1_err(serve_in, f"tile {TILE} at {W}x{H} (serving)")
    for ts in (8, 16, 32):
        k1_err(kernel_inputs(scene, viewmats[0], scaled_K(K, check_wh[0] / W), *check_wh, ts,
                             cap, row_cap), f"tile {ts} at {check_wh[0]}x{check_wh[1]}")

    # Times at the serving shapes, and the least time the card could take.
    n_live, n_rows, n_slots = serve_in["n_live"], serve_in["n_rows"], serve_in["n_slots"]
    F = serve_in["k1"][0].shape[0]  # 6 + D field rows
    D = F - 6
    pairs = evaluated_pairs(*serve_in["k1"])
    work = {
        "expand_rows": (4 * (16 * n_live + 1 + 5 * row_cap), 0),
        "expand_emission": (4 * (6 * n_rows + F * n_live + 1 + (1 + F) * cap), 0),
        "rasterize_fwd": (4 * (F * n_slots + (serve_in["k1"][4] * serve_in["k1"][5] + 1)
                               + W * H * (D + 1)), K1_FLOP_PER_PAIR * pairs),
    }
    calls = {"expand_rows": (gk.expand_rows, gk.expand_rows_plain, serve_in["k3"]),
             "expand_emission": (gk.expand_emission, gk.expand_emission_plain, serve_in["k4"]),
             "rasterize_fwd": (rk.rasterize_fwd, rk.rasterize_fwd_plain, serve_in["k1"])}
    records = []
    for name, (fn, plain, args) in calls.items():
        nbytes, nops = work[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
        rec = {
            "name": name, "route": "cuda", "source": "gsplat_tpu_torch/" + KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": timer(lambda: fn(*args), 20),
            "plain_ms": timer(lambda: plain(*args), 2),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        records.append(rec)
    log(f"rasterize_fwd at {W}x{H}: {pairs} (pixel, slot) pairs evaluated, {n_slots} slots")
    del serve_in

    # Profile: each stage of request 0 timed alone, then device time by kernel.
    _, stages = forward_stages(scene, viewmats[0], K, W, H, TILE, cap, row_cap)
    times = {name: timer(fn, 10) for name, fn in stages}
    times["sum of stages"] = sum(times.values())
    times["whole request"] = timer(lambda: sv.request(viewmats[0]), 10)
    for name, ms in times.items():
        log(json.dumps({"stage": name, "ms": ms}))
    if dev.type == "cuda":
        device_profile(lambda: sv.request(viewmats[0]), times["whole request"], log)
    return serve, records


def device_profile(request, request_ms: float, log, n_req: int = 3) -> None:
    """A torch.profiler trace of `n_req` requests: device time by kernel, and
    the device's busy and idle share of the unprofiled request time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_req):
            request()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(bool(kernels), "the profiler recorded no device time")
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_req
    busy = sum(by_name.values())
    log(json.dumps({"device_ms_per_request": busy, "request_ms": request_ms,
                    "device_idle_share": 1.0 - busy / request_ms,
                    "kernel_launches_per_request": len(kernels) / n_req}))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(json.dumps({"kernel": name[:100], "ms_per_request": ms}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s ({json.dumps({k: round(v, 1) for k, v in built.items()})})",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain composite's colour sum
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, records = run(torch.device("cuda"), N_CELL, GRID, SERVE_WH, CHECK_WH, cuda_timer,
                         log=lambda m: print(m, flush=True))
    except Fail as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
