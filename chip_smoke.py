"""Drive the PyTorch port's main paths, serving, the analysis ops, 3DGS
training, 2DGS training, the 3DGUT render and the AV trainer, on one NVIDIA
card and hold each CUDA kernel against its plain PyTorch version.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card's name and power limit (nvidia-smi), build the kernels
     from csrc/ (one nvcc per source, in parallel) and print the seconds,
     then the registers and spills nvcc reports for K1, K7b, K2, K5, K6a,
     K6b and K9 (and any spill of another kernel);
  2. serving: a synthetic scene of the benchmark's size (2,794,625
     gaussians, SH degree 3, 25 grid cells of 111,785 points, made from a
     fixed seed) goes through splats_from_numpy -> GaussianScene ->
     GaussianInferenceScene -> Stage and renders 4 look-at requests at
     3840x2160 (tile 16) at render_scene's default, the fast path (the
     bf16-pair packed payload), after one sizing/warm-up pass; then one
     exact request (fast=False) per view.  Every kernel's launch count is set
     to 0 just before each path's 4 requests and read just after: K3, K4
     packed and K1 packed must be > 0 on the fast path, K3, K4 and K1 on the
     exact one.  Each fast image is held to its exact one within the fast
     path's class (mean < 5e-3, 99.9% < 0.05);
  3. reference: a small crop renders on the card and on the CPU (plain
     versions), exact and fast, and the images must agree (band tolerance);
     then the same crop at 960x540 with 64 colour channels, which the
     composites take in two groups of 32, renders and takes the backward of
     a squared loss on the card and on the CPU: images in the band,
     gradients in the gradient reference's band (phase 7), K1 and K2
     launched once per group;
  4. kernels: the rasterizer's stages rerun on request 0's camera, exact
     and packed, and must give that path's request-0 image bit for bit; K3,
     K4 and K4 packed against their plain versions on those inputs (exact),
     K1 at the serving shape (max |d| <= 1e-4) and K1 packed there bit for
     bit, both again at 960x540 with tiles 8, 16 and 32, and K2 (float32, and
     packed with bf16-pair gradients) at 960x540 on each K1's outputs (1e-4
     of each row's largest entry, after unpacking, one bf16 ulp allowed);
     each forward kernel timed at the serving shape with CUDA events;
  5. profile: each stage of a fast and of an exact request timed alone, and
     a torch.profiler trace of 3 fast requests giving device time by kernel
     and the device's busy and idle share;
  5a. analysis, on the serving scene and request 0's camera at 3840x2160:
     the classic public pipeline (fully_fused_projection -> isect_tiles,
     its capacity from a sizing pass -> isect_offset_encode), with
     n_isects held to the AABB plan's and every tile's span to
     expand_sort_align's; rasterize_to_pixels_ref (bands of tiles) against
     rasterize_to_pixels (K3, K4, K1) in the band; the contributing ops
     (the accumulated alpha against K1's, the ids' weights summing to it,
     the top 8 a subset of the ids with their weights); sparse
     rasterization at 65,536 seeded pixels against the oracle there, its
     backward (K5) equal bit for bit on a rerun and in the gradient band
     of phase 7 against the CPU; at 1920x1080 rasterize_to_indices_in_range
     with accumulate (K5) over 256-slot batches against K1 (in the band on
     the pixels that never stopped; elsewhere within the bounds its resume
     of a stopped pixel allows); the losses and color_correct_affine on the
     card against the CPU (1e-5 relative).  Launch counts are set to 0
     just before and read just after (the span cross-check runs before):
     K1, K3, K4, K5 and K8 must be > 0.  Each step prints its ms and
     (pixel, slot) pairs; the phase its seconds and peak memory;
  6. training: the same points and colours, as an in-memory npz-like dict
     with the 4 orbit cameras, go through gsplat_tpu_torch.trainer.Trainer
     at its defaults (packed payload and gradients; MCMC strategy, cap_max =
     the number of points, batch 1, SH degree 3 reached within the run,
     refine from step 1 every 3 steps) for 9 steps at 3840x2160, on targets
     rendered once beforehand (exactly).  Launch counts are set to 0 just
     before train() and read just after; K3, K4 packed, K1 packed, K2 packed
     and K5 must all be > 0.  A recorder around the trainer's run_step and
     update takes each step's ms, peak memory, loss and gradient check.
     Required: finite loss and gradients at every step, a lower loss at the
     last step than at the first step on the same view, no isect_overflow,
     an alive count that did not fall, a refine and a noise injection;
  7. gradient reference: on the small crop, one forward and backward on the
     card and one on the CPU (plain versions) give the same gradients of
     every parameter, packed (the pack_grads band) and exact;
  8. training kernels: K2 packed with bf16-pair gradients against its plain
     version on a training step's own inputs at 3840x2160, on the tiles with
     the longest spans and a seeded sample of the others (each row within
     1e-5 of its largest entry after unpacking, one bf16 ulp allowed; the
     live pairs equal to K1 packed's contributing pairs in every tile); then,
     on one more step with both packed flags off, K2 (1e-4 of each row's
     largest entry on every tile, the live pairs equal to K1's) and K5
     (bit for bit, and on a rerun), each timed, K5 beside
     torch.segment_reduce;
  9. training profile: the stages of 3 training steps by CUDA events, and a
     torch.profiler trace of 3 steps;
 10. 2DGS training: the same points and colours go through
     gsplat_tpu_torch.trainer_2dgs.Trainer2DGS (default strategy at its
     defaults, capacity 6x the points, refine from step 1 every 3 steps and
     an opacity reset every 6, normal and distortion losses from step 0;
     every 97th surfel starts below the prune threshold)
     for 9 steps at 3840x2160, on targets rendered once beforehand (no
     checkpoint is written); the intersection capacity comes from a
     counting pass.  Launch counts are
     set to 0 just before train() and read just after; K5, K6a, K6b, K8 and
     K9 must all be > 0.  Each step's ms, peak memory and loss, the slots
     and overflow, the gaussians each refine adds and prunes (growth must
     happen, and the first refine must prune at least the planted surfels)
     and the held-out PSNR are printed;
 11. 2DGS kernels, on one more training step's own inputs at 3840x2160 (the
     step's peak device memory is printed for each interval between K6a,
     K6b and the scatter to emission order): K5
     bit for bit (and on a rerun), timed beside torch.segment_reduce (the
     `kernels` line files these under K5's `2dgs_check`); K9 (the gather of
     each sorted slot's fields from its gaussian's record) and K8 in the
     path's mode (no field table) equal to their plain versions bit for
     bit, and to the route they replace (K8's full mode, then align_rows
     through the sort), which is held to its plain versions and timed too
     (K8's `full_mode`, K9's `align_rows`); K6a bit for bit on the
     tiles with the longest spans and a seeded sample of the others (the
     plain replay of every tile at 4k would take hours), with its
     contributing pairs equal to K6b's live pairs in every tile, and no
     pair gated by its early reject that the exact path would keep (its
     counting build runs both on every rejected pair; the pairs evaluated,
     the share through the exact path and the contributing pairs are
     printed); K6b within
     1e-4 of each row's largest entry on the same tiles; with only the
     median's cotangent set, the depth row of K6b's output equal to the
     count of pixels whose median each slot is; the largest sorted position
     against 2^24.  Each kernel timed, K9 beside torch.index_select of the
     same records.
 12. 3DGUT: the same scene's activated parameters render one 3840x2160 view
     through rasterization(with_ut=True, with_eval3d=True) on a pinhole with
     OpenCV radial distortion (GUT_RADIAL), RGB-Ed and normals, so that
     every optional field row of K7a and K7b is live; the intersection
     capacity is the AABB count of a first pass.  Launch counts are set to 0
     just before 3 repetitions of the render and the backward of an l1 loss
     and read just after; K5, K7a, K7b, K8 and K9 must all be > 0.  Each
     repetition prints its slots, overflow flag, render and backward ms and
     peak memory; the image, the hit distances and every gradient must be
     finite, and the gradients nonzero.  Then 3 more are timed whole and
     traced;
 13. eval3d kernels, on one more render's own inputs: K9 bit for bit and
     timed (K9's `3dgut_check`); K7a bit for bit on the
     tiles with the longest spans and a seeded sample of the others, its
     contributing pairs equal to K7b's live pairs in every tile, no pair
     gated by its early reject (the block masks of csrc/ray3d.cuh) that the
     exact path keeps (the counting build runs both on every rejected pair),
     every tile on the hoisted route of one origin, and the pairs evaluated,
     through the exact path and contributing printed; K7b within
     1e-5 of each row's largest entry on the same tiles (the per-pixel ray
     gradients too), and bit for bit from run to run.  Both timed;
 14. AV training: av_trainer.AVRunner trains 9 steps of a street scene (the
     wall and ground of synthetic_scene, 5x larger, 1,000,000 gaussians,
     cap_max the same), 3 cameras at 1920x1280 and one spinning lidar of
     64 x 2,650 elements over 360 degrees, elevations +2.4 to -17.6 degrees
     (the Waymo Open Dataset TOP lidar's range image).  Launch counts are
     set to 0 just before train() and read just after; K1 to K5 and K7a,
     K7b, K8, K9 must all be > 0.  Each step prints its ms, loss, peak
     memory, lidar slots and both lidar losses, which must be finite; the
     loss must fall.  Then 3 more steps are timed whole and traced;
 15. lidar kernels, on one more AV step's lidar render (the hit channel
     without normals, D = 2, lidar rays): the checks of phase 13 on every
     tile of the range image (K9's `av_check`; K7a's tiles of one origin
     counted, not required); K1 (float32) on the same
     step's 3 camera renders against its plain version on every tile
     (within 1e-4), timed (K1's `av_check`, its path's, beside the 4k
     exact request's record); and K2 (float32) on those renders, against
     its plain version on sampled tiles as in phase 8, timed: the `kernels`
     line's K2 record is this one, its path's, with the 4k training step's
     numbers under `4k_check`.  The
     `kernels` line keeps the 3DGUT shapes' numbers for K7a and K7b, the
     larger error of the two checks, and the lidar's under `av_check`;
 16. COLMAP training: the grid scene renders 9 look-at views at 3840x2160
     exactly on the card, written as PNGs (zlib) beside a binary COLMAP
     model (one PINHOLE camera, the 9 views, the centre cell's 111,785
     points and colours as points3D.bin); the datasets.colmap Parser reads
     it (timed), and gsplat_tpu_torch.trainer.Trainer(Config(data="colmap",
     factor=1, save_ply=True)) at its defaults (the default strategy,
     packed payload and gradients) trains 6 steps on the 7 views of the
     test_every=8 split.  Launch counts are set to 0 just before train()
     and read just after; K3, K4 packed, K1 packed, K2 packed and K5 must
     all be > 0.  Each step prints its ms, peak memory and loss (finite,
     finite gradients, no overflow); the eval of the training views prints
     PSNR, SSIM, LPIPS (None: no weights file), the LPIPS proxy, the
     gaussians, the device memory and the time since training started, all
     finite; the .ply of the live gaussians (its bytes printed) goes back
     through load_checkpoint and render_scene and must give, bit for bit,
     the image of the trainer's own live parameters.
 17. COLMAP training with every add-on, on phase 16's written scene:
     Trainer(Config(data="colmap", factor=1, max_steps=6, pose_opt=True,
     pose_noise=1e-3, app_opt=True, bilateral_grid=True, ppisp=True,
     tb_every=1, tb_save_image=True, render_traj=True,
     render_traj_path="interp", traj_frames=8, compression="png",
     save_ply=True)) with the packed defaults and the default strategy
     (the pose chain at zero deltas gives the parser's cameras back).
     Launch counts set to 0 just before train() and read just after (K3, K4
     packed, K1 packed, K2 packed, K5 > 0; the eval, the trajectory and the
     k-means launch there too).  Per step: the loss finite, the gradients
     of the splats, the pose deltas (the step's view's row among the
     training views'), the grids, the appearance head and PPISP finite and
     not all zero; each add-on moved after the 6 steps.  The checkpoint
     loads into a fresh Trainer bit for bit (parameters, moments, add-ons
     and their moments).  On view 0's 4k render the card's slice, PPISP and
     appearance head against the CPU's (1e-5 of the largest entry, forward
     and the gradient of a seeded cotangent; each timed forward and
     backward).  The compression: every plane, the decompression to the
     334^2 crop within half an 8-bit step (means: half a 16-bit step in log
     space) of the cropped, sorted splats; the k-means labels of the card
     against the CPU's (phase 16's trained shN rows: this phase's are zero
     under the appearance head; one assignment to the card's centres on
     both, the share of equal labels printed), one PLAS sort timed, the
     decompressed splats' render of view 0 against the live splats' (PSNR),
     the bytes against the .ply's.  The trajectory's frames (interp: 8 // 6
     a segment, 6 frames) decode, not constant; TensorBoard's event file,
     or where it is not installed the trainer's note.  Last, 3 more steps
     timed with TensorBoard closed, and 3 traced (device time by kernel,
     idle share).
It prints one `kernels` JSON line (14 kernels, each with its launches on
every path and `launches` on its own: MAIN_PATH; K1's records also carry
`exp_bound_ms`, one exp per evaluated pair on the special-function units;
K6a's, K6b's and K7a's bounds count the work given their early rejects, with
the whole response on every evaluated pair under `every_pair_bound_ms`)
and, last, the `ok` JSON line; any failure exits non-zero without it.  The script never falls back
to the CPU.
"""

from __future__ import annotations

import builtins
import collections
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gsplat_tpu_torch import _build, color_correct_affine, rasterization
from gsplat_tpu_torch import losses as losses_mod
from gsplat_tpu_torch import av_trainer as av_mod
from gsplat_tpu_torch import trainer as trainer_mod
from gsplat_tpu_torch import trainer_2dgs as trainer2d_mod
from gsplat_tpu_torch.ops import bf16pair
from gsplat_tpu_torch.ops import contributing as contrib
from gsplat_tpu_torch.ops import gather_kernel as gk
from gsplat_tpu_torch.ops import rasterize as rz
from gsplat_tpu_torch.ops import rasterize2d as r2d
from gsplat_tpu_torch.ops import rasterize2d_kernel as r2k
from gsplat_tpu_torch.ops import rasterize_eval3d as r3d
from gsplat_tpu_torch.ops import rasterize_eval3d_kernel as r3k
from gsplat_tpu_torch.ops import rasterize_kernel as rk
from gsplat_tpu_torch.ops import rasterize_ref as rref
from gsplat_tpu_torch.ops import rasterize_sparse as sparse_mod
from gsplat_tpu_torch.ops import segsum_kernel as sk
from gsplat_tpu_torch.strategy import ops as strategy_ops
from gsplat_tpu_torch.ops.isect import isect_offset_encode, isect_tiles
from gsplat_tpu_torch.ops.projection import fully_fused_projection
from gsplat_tpu_torch.ops.sh import spherical_harmonics
from gsplat_tpu_torch.rendering import _campos_from_viewmats
from gsplat_tpu_torch.datasets import Parser, decode_png, encode_png, write_model_binary
from gsplat_tpu_torch.scene import (
    GaussianInferenceScene,
    Stage,
    load_checkpoint,
    render_scene,
    splats_from_numpy,
)
from gsplat_tpu_torch.sensors.lidars import SpinningDirection, make_lidar

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

def k2_flop_per_live_pair(D: int) -> int:
    """What K2's function needs for a live pair beyond K1's replay: 29 + 3D
    f32 operations for the gradient terms (w, d, E, 1/(1-alpha), v_alpha,
    v_sigma, v_op, the five geometry terms, D colour terms) and one add into
    each of the 6+D per-slot sums.  How the kernel adds (its shuffle tree) is
    its own cost, not the function's."""
    return (29 + 3 * D) + (6 + D)


TRAIN_STEPS = 9  # views 0,1,2 three times; SH degree 3 from step 6
TRAIN_SH_INTERVAL = 2
TRAIN_HEADROOM = 1.6  # capacity over the initial model's count: the splats grow as they train
KERNELS = {
    "expand_rows": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:396"),
    "expand_emission": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:584"),
    "rasterize_fwd": ("csrc/rasterize_fwd.cu", "gsplat_tpu/ops/rasterize_pallas.py:330"),
    "rasterize_bwd": ("csrc/rasterize_bwd.cu", "gsplat_tpu/ops/rasterize_pallas.py:475"),
    "segment_rowsum": ("csrc/segsum.cu", "gsplat_tpu/ops/segsum_pallas.py:38"),
    "expand_emission_aabb": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:120"),
    "gather_records": ("csrc/align.cu", "gsplat_tpu/ops/gather_pallas.py:274"),
    "rasterize2d_fwd": ("csrc/rasterize2d_fwd.cu", "gsplat_tpu/ops/rasterize2d_pallas.py:92"),
    "rasterize2d_bwd": ("csrc/rasterize2d_bwd.cu", "gsplat_tpu/ops/rasterize2d_pallas.py:213"),
    "rasterize_eval3d_fwd": ("csrc/rasterize_eval3d_fwd.cu",
                             "gsplat_tpu/ops/rasterize_eval3d_pallas.py:122"),
    "rasterize_eval3d_bwd": ("csrc/rasterize_eval3d_bwd.cu",
                             "gsplat_tpu/ops/rasterize_eval3d_pallas.py:232"),
    # the packed modes: K4's bf16-pair emission with tile-local means, K1's
    # packed composite, K2's packed replay with bf16-pair gradients
    "expand_emission_packed": ("csrc/expand.cu", "gsplat_tpu/ops/gather_pallas.py:691"),
    "rasterize_fwd_packed": ("csrc/rasterize_fwd.cu", "gsplat_tpu/ops/rasterize_pallas.py:399"),
    "rasterize_bwd_packed": ("csrc/rasterize_bwd.cu", "gsplat_tpu/ops/rasterize_pallas.py:613"),
}
# Each kernel's launch count: (wrapper, attribute); a packed mode counts on
# the wrapper of its kernel, in `launches_packed`.
COUNTERS = {"expand_rows": (gk.expand_rows, "launches"),
            "expand_emission": (gk.expand_emission, "launches"),
            "rasterize_fwd": (rk.rasterize_fwd, "launches"),
            "rasterize_bwd": (rk.rasterize_bwd, "launches"),
            "segment_rowsum": (sk.segment_rowsum, "launches"),
            "expand_emission_aabb": (gk.expand_emission_aabb, "launches"),
            "gather_records": (gk.gather_records, "launches"),
            "align_rows": (gk.align_rows, "launches"),
            "rasterize2d_fwd": (r2k.rasterize2d_fwd, "launches"),
            "rasterize2d_bwd": (r2k.rasterize2d_bwd, "launches"),
            "rasterize_eval3d_fwd": (r3k.rasterize_eval3d_fwd, "launches"),
            "rasterize_eval3d_bwd": (r3k.rasterize_eval3d_bwd, "launches"),
            "expand_emission_packed": (gk.expand_emission, "launches_packed"),
            "rasterize_fwd_packed": (rk.rasterize_fwd, "launches_packed"),
            "rasterize_bwd_packed": (rk.rasterize_bwd, "launches_packed")}


def reset_launches() -> None:
    for obj, attr in COUNTERS.values():
        setattr(obj, attr, 0)


def read_launches() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in COUNTERS.items()}


# The kernels each path must launch.  Serving renders RGB at render_scene's
# default, the packed fast path; one exact request per view keeps the float32
# kernels at the serving shape.  The 3DGS trainer packs by default; the AV
# trainer's camera renders do not.
EXACT_RENDER_KERNELS = ("expand_rows", "expand_emission", "rasterize_fwd")
SERVING_KERNELS = ("expand_rows", "expand_emission_packed", "rasterize_fwd_packed")
TRAINING_KERNELS = SERVING_KERNELS + ("rasterize_bwd_packed", "segment_rowsum")
SURFEL_KERNELS = ("expand_emission_aabb", "gather_records", "rasterize2d_fwd", "rasterize2d_bwd",
                  "segment_rowsum")
SURFEL_STEPS = 9
COLMAP_VIEWS = 9  # test_every=8 leaves views 0 and 8 out: 7 training views
COLMAP_STEPS = 6
# the default strategy's schedule, cut so that 9 steps refine (at steps 3
# and 6) and reset opacities (at 6)
SURFEL_SCHEDULE = dict(refine_start_iter=1, refine_every=3, reset_every=6)
# Every PLANT_EVERY-th surfel starts at opacity PLANTED_OPACITY, below the
# alpha gate (so it gets no gradient and stays there) and below the default
# prune threshold 0.005: the first refine must prune at least those.  From
# the trainer's opacity 0.1 no surfel falls below 0.005 in a few steps (the
# reset only clamps to twice the threshold).
PLANT_EVERY, PLANTED_OPACITY = 97, 0.001
K6A_FLOP_PER_PAIR = 42  # the exact path's surfel response per (pixel, slot), csrc/surfel.cuh
# csrc/surfel.cuh's early reject per slot a tile reaches: the gate term (12
# finiteness tests, ln and 4 more), the three components' A, B, C, a, b, k,
# S, e and reach (39 each), and per 8x4 block its centre's c (6 fused
# multiply-adds, 12 operations) and 25 more to test it
K6A_FLOP_PER_SLOT_MASK = 17 + 3 * 39 + 1 + 8 * (2 + 12 + 23)
PLAIN_TILES = (16, 112)  # K6a, K6b, K7a, K7b plain: the longest spans, then a seeded sample
EVAL3D_KERNELS = ("expand_emission_aabb", "gather_records", "rasterize_eval3d_fwd",
                  "rasterize_eval3d_bwd", "segment_rowsum")
# the 3DGUT phase: one 3840x2160 view of the grid-5 scene through a pinhole
# with OpenCV radial distortion (k1, k2, k3), every optional eval3d row live
GUT_RADIAL = (0.08, -0.02, 0.004)
GUT_REPS = 3
GUT_KW = dict(sh_degree=3, with_ut=True, with_eval3d=True, render_mode="RGB-Ed",
              return_normals=True, near_plane=0.01, far_plane=100.0, radius_clip=3.0)
# the AV phase: synthetic_scene's wall and ground, 5x larger, with 1,000,000
# gaussians; 3 cameras at the Waymo Open Dataset front-camera size; one
# spinning lidar laid out as the Waymo TOP lidar's range image
AV_N, AV_SCALE, AV_STEPS = 1_000_000, 5.0, 9
AV_WH = (1920, 1280)
LIDAR_ROWS, LIDAR_COLS, LIDAR_ELEV_DEG = 64, 2650, (2.4, -17.6)
AV_KERNELS = EXACT_RENDER_KERNELS + ("rasterize_bwd", "segment_rowsum") + EVAL3D_KERNELS
# the path whose run gives each kernel's `launches` in the kernels line
MAIN_PATH = {**{k: "serving" for k in SERVING_KERNELS},
             "expand_emission": "serving_exact", "rasterize_fwd": "serving_exact",
             "rasterize_bwd_packed": "training", "segment_rowsum": "training",
             "rasterize_bwd": "av",
             **{k: "2dgs" for k in SURFEL_KERNELS if k != "segment_rowsum"},
             "rasterize_eval3d_fwd": "3dgut", "rasterize_eval3d_bwd": "3dgut"}
# csrc/ray3d.cuh's exact path per (pixel, slot) with g = M o - M x hoisted
# (one origin): u = M d (15), |u|^2 (5), its square root and reciprocal (2),
# u^ (3), c (9), gray (5), hit_t (6), the exp and its argument (2), alpha (1)
K7A_FLOP_PER_PAIR = 48
K7A_FLOP_PER_PAIR_ORIGIN = 18  # with origins that differ: the pair's M o and g
# the whole response, g included, on every evaluated pair: K7b's replay, and
# K7a's bound before the hoisting and the early reject (`every_pair_bound_ms`)
K7A_FLOP_EVERY_PAIR = 68
# csrc/ray3d.cuh's hoisting and early reject per slot a tile reaches: M x
# (15), the gate term (16 with its finiteness tests), the Gershgorin bound
# (63), |x| (6), and per 8x4 block ray_block_gated (176: M times the
# bundle's three vectors, three cross products, the componentwise lower
# bound, the norms, the envelope, u . g and its bound, the two tests); and
# g (K7A_FLOP_PER_PAIR_ORIGIN) once with one origin, else once per block
K7A_FLOP_PER_SLOT_MASK = 15 + 16 + 63 + 6 + 8 * 176


def k7a_flop_per_live_pair(D: int, hit: bool, normals: bool) -> int:
    """A live pair's weight and D colour sums; the hit distance (|s u^|, its
    square root, hd, its sum) and the flipped normal (n . d, sign, 3 sums)."""
    return 1 + 2 * (D - hit) + 12 * hit + 12 * normals


def k7a_gate_flops(exact_counts: torch.Tensor, eval_counts: torch.Tensor,
                   one_origin: torch.Tensor) -> int:
    """The operations K7a's function needs to decide its pairs, given the
    hoisting and the early reject: the exact path on each pair the block
    masks do not gate (with the pair's own g where the tile's rays have more
    than one origin), and the per-slot terms and block masks once per slot
    that a tile reaches (at least ceil(evaluated / 256), the count taken, as
    in k6_gate_flops; g once a slot with one origin, else once a block)."""
    several = 1 - one_origin.long()
    per_pair = K7A_FLOP_PER_PAIR + K7A_FLOP_PER_PAIR_ORIGIN * several
    per_slot = K7A_FLOP_PER_SLOT_MASK + K7A_FLOP_PER_PAIR_ORIGIN * (1 + 7 * several)
    reached = (eval_counts.long() + 255) // 256
    return int((exact_counts.long() * per_pair + reached * per_slot).sum())


def k7b_flop_per_live_pair(D: int, F: int) -> int:
    """What K7b's function needs for a live pair beyond the replay: the
    channel chain (2D + 15 with normals), E, 1/(1-alpha) and v_alpha (10),
    v_sigma, v_op and v_c (6), the two cross-product transposes (18), the hit
    distance (22), hit_t (12), the normalization (14), the nine v_M terms
    (27), the six ray gradients (36), and one add into each of the F
    per-slot sums."""
    return 2 * D + 15 + 10 + 6 + 18 + 22 + 12 + 14 + 27 + 36 + F


def k6a_flop_per_live_pair(D: int) -> int:
    """A live pair's weight, its D + 3 channel sums, distortion, A, B and
    the median test."""
    return 2 * (D + 3) + 10


def k6_gate_flops(n_exact: int, eval_counts: torch.Tensor) -> int:
    """The operations K6a's and K6b's function needs to decide its pairs,
    given the early reject: the exact path on each pair the block masks do
    not gate, and one gate term and block mask per slot that a tile reaches.
    A tile's walk reaches a prefix of its span, each slot of it at no more
    than its 256 pixels, so it reaches at least ceil(evaluated / 256) slots;
    that least count is the one taken."""
    reached = int(((eval_counts.long() + 255) // 256).sum())
    return K6A_FLOP_PER_PAIR * n_exact + K6A_FLOP_PER_SLOT_MASK * reached


def k6b_flop_per_live_pair(D: int) -> int:
    """What K6b's function needs for a live pair beyond the replay: the
    channel chain (2(D+3) + 10), the distortion chain (20), alpha to sigma
    and opacity (4), the 3D branch's cross-product transposes and the ray
    transform rows (48, the larger branch), D + 3 channel gradients, and one
    add into each of the 15 + D per-slot sums."""
    return (2 * (D + 3) + 10) + 20 + 4 + 48 + (D + 3) + (15 + D)


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
                   row_cap: int, packed: bool):
    """One request's rasterizer forward, split into the named stages that
    rendering.rasterization and ops/rasterize.py run (`packed`: the fast
    path's packed emission and composite, else the exact path's).  The
    stages share one state dict; run in order, they leave each kernel's
    arguments in it ("k4" and "k4_kw", "k1" and "k1_kw", and "plan_args" for
    K3) and the composite's output in "out".  The profile phase times each
    alone."""
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
        st["k4_kw"] = dict(packed=packed, tile_size=ts)
        st["emitted"] = gk.expand_emission(*st["k4"], **st["k4_kw"])

    def sort():
        fields_s, bounds, st["order"] = rz.sort_slots(*st["emitted"], T)
        st["k1"] = (fields_s, bounds, 1, ts, tw, th, W, H)
        st["k1_kw"] = dict(packed=packed, n_channels=st["table"].shape[0] - 6)

    def composite():
        st["out"] = rk.rasterize_fwd(*st["k1"], **st["k1_kw"])

    name = "packed " if packed else ""
    return st, [("projection + SH", inputs), ("compaction sort", compact),
                ("tight plan (incl. K3)", plan), ("field table", table),
                (f"{name}emission K4", emit), ("slot sort + spans", sort),
                (f"{name}composite K1", composite)]


def kernel_inputs(scene, vm, K, W: int, H: int, ts: int, cap: int, row_cap: int,
                  packed: bool = False):
    """Run the forward stages once; keep each kernel's arguments and output."""
    st, stages = forward_stages(scene, vm, K, W, H, ts, cap, row_cap, packed)
    for _, fn in stages:
        fn()
    plan = st["plan"]
    require(not bool(plan.overflow), f"kernel inputs overflow at {W}x{H} tile {ts}")
    geo = rz.row_geometry(*st["plan_args"], row_cap)
    return dict(
        inp=st["inp"], k3=(geo.gg_f, geo.gg_i, geo.n_rows, row_cap, ts, 1), k4=st["k4"],
        k4_kw=st["k4_kw"], k1=st["k1"], k1_kw=st["k1_kw"], out=st["out"],
        n_live=int(st["comp"].n_live), n_rows=int(geo.n_rows[0]), n_slots=int(plan.n_slots[0]),
        n_isects=int(plan.n_isects),
    )


def evaluated_pairs(fields, bounds, n_images, tile, tiles_w, tiles_h, width, height,
                    n_channels=None) -> int:
    """(pixel, slot) pairs K1 evaluates on its arguments: each in-image pixel
    reads its tile's slots up to and including the one that stops it.  The
    work count behind K1's bound, from the plain composite's batches
    (`n_channels`: the packed payload's D)."""
    total = 0
    for ids, L in rk.tile_sets(bounds, n_images * tiles_w * tiles_h, tile * tile):
        cb = rk._composite_batch(fields, bounds, ids, L, tile, tiles_w, tiles_w * tiles_h, width,
                                 height, n_channels)
        total += int((cb.evaluated * cb.inside).sum())
    return total


def band_close(a: torch.Tensor, b: torch.Tensor, name: str, strict=3e-5, frac=0.05, hard=2e-4):
    diff = (a.double() - b.double()).abs()
    bad = float((diff > strict).double().mean())
    worst = float(diff.max())
    require(bad < frac and worst < hard, f"{name}: {bad:.4f} of values over {strict}, max {worst}")
    return worst


def cuda_timer(fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call over `reps` calls, after one warm-up unless the
    caller has run `fn` already, by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops) -> float:
    """The least time for moving `nbytes` and doing `nops` float32
    operations on the card: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3


def kernel_record(name, launches, err, ms, plain_ms, nbytes, nops, library_ms=None):
    """One entry of the `kernels` line; the bound is the larger of the bytes
    over the card's memory rate and the operations over its float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
    return {
        "name": name, "route": "cuda", "source": "gsplat_tpu_torch/" + KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
        "bytes_bound_ms": t_bytes, "operations_bound_ms": t_ops,
    }


def rows_close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str, log) -> float:
    """Every row of `got` within `tol` times the largest entry of the same
    row of `want`, which must be above 0 (a row of zeros would hold nothing
    to its value).  Logs the rows' largest entries; returns (the worst
    ratio, the largest absolute difference)."""
    scales = want.abs().amax(dim=1)
    errs = (got - want).abs().amax(dim=1)
    log(f"{what}: largest |entry| by row " + json.dumps([float(f"{v:.3g}") for v in scales])
        + ", largest |d| by row " + json.dumps([float(f"{v:.3g}") for v in errs]))
    require(bool((scales > 0).all()) and bool(torch.isfinite(want).all()),
            f"{what}: a row of the plain version is zero or not finite")
    ratios = errs / scales
    r = int(ratios.argmax())
    require(float(ratios[r]) <= tol,
            f"{what}: row {r} differs by {float(ratios[r]):.3g} of its largest entry")
    return float(ratios[r]), float(errs.max())


def carriers_close(got: torch.Tensor, want: torch.Tensor, n_rows: int, tol: float, what: str,
                   log):
    """`rows_close` for bf16-pair carriers (pack_grads), compared after
    unpacking: each half within `tol` of its row's largest entry, or within
    one bf16 ulp (at most 2^-7 of the value) of the plain version's, since
    two sums a few float32 ulps apart can round to neighbouring bf16 values.
    Returns (the worst ratio beyond that ulp, the largest absolute
    difference)."""
    g, w = bf16pair.unpack_rows(got, n_rows), bf16pair.unpack_rows(want, n_rows)
    scales = w.abs().amax(dim=1)
    diff = (g - w).abs()
    over = torch.clamp(diff - 2.0**-7 * torch.maximum(g.abs(), w.abs()), min=0.0).amax(dim=1)
    log(f"{what}: largest |entry| by row " + json.dumps([float(f"{v:.3g}") for v in scales])
        + ", largest |d| beyond one bf16 ulp by row "
        + json.dumps([float(f"{v:.3g}") for v in over]))
    require(bool((scales > 0).all()) and bool(torch.isfinite(w).all()),
            f"{what}: a row of the plain version is zero or not finite")
    ratios = over / scales
    r = int(ratios.argmax())
    require(float(ratios[r]) <= tol,
            f"{what}: row {r} differs by {float(ratios[r]):.3g} of its largest entry")
    return float(ratios[r]), float(diff.max())


def tile_slots(bounds, tiles) -> torch.Tensor:
    """The sorted positions of the slots of `tiles`."""
    return torch.cat([torch.arange(int(bounds[t]), int(bounds[t + 1]), device=bounds.device)
                      for t in tiles.tolist()])


@torch.no_grad()
def check_bwd_kernel(args, what: str, log, tol: float = 1e-4, tiles=None, **modes):
    """K2 against its plain version on `args` (rasterize_bwd's positional
    arguments) in the mode `modes` (packed, pack_grads, n_channels), on every
    tile or on `tiles`.  Each row within `tol` of the row's own largest
    entry, which must not be 0: the order of the sum over a tile's pixels
    differs (with pack_grads, after unpacking, and one bf16 ulp allowed).
    On the card the live pairs must equal the forward's contributing pairs in
    every tile and the plain count exactly, and a second run must give the
    same bits.  Returns (the largest absolute error, live pairs, the plain
    version's ms on the host clock)."""
    fields, bounds = args[0], args[1]
    on_card = fields.device.type == "cuda"
    n_tiles = bounds.shape[0] - 1
    n_sorted = int(bounds[-1])
    live = torch.empty(n_tiles, dtype=torch.int32, device=fields.device) if on_card else None
    got = rk.rasterize_bwd(*args, live_counts=live, **modes)
    require(bool((got.view(torch.int32)[:, n_sorted:] == 0).all()),
            f"rasterize_bwd {what}: tail not zero bits")
    if on_card:
        again = rk.rasterize_bwd(*args, **modes)
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"rasterize_bwd {what}: two runs differ")
        del again
    t = time.perf_counter()
    want, n_live = rk.rasterize_bwd_plain(*args, tiles=tiles, **modes)
    sync(fields.device)
    plain_ms = (time.perf_counter() - t) * 1e3
    if tiles is not None:
        sel = tile_slots(bounds, tiles)
        got, want = got[:, sel], want[:, sel]
    if modes.get("pack_grads"):
        D = modes.get("n_channels") if modes.get("packed") else fields.shape[0] - 6
        worst, err = carriers_close(got, want, 6 + D, tol, f"rasterize_bwd {what}", log)
    else:
        worst, err = rows_close(got, want, tol, f"rasterize_bwd {what}", log)
    del got, want
    if on_card:
        kept = torch.empty_like(live)
        fwd_modes = {k: v for k, v in modes.items() if k != "pack_grads"}
        rk.rasterize_fwd(*args[:8], pair_counts=kept, **fwd_modes)
        require(torch.equal(live, kept),
                f"rasterize_bwd {what}: live pairs differ from the forward's in "
                f"{int((live != kept).sum())} tiles")
        in_check = live if tiles is None else live[tiles]
        require(int(in_check.sum()) == n_live, f"rasterize_bwd {what}: live pairs != plain")
        n_live = int(live.sum())
    on = "" if tiles is None else f" on {tiles.numel()} of {n_tiles} tiles"
    log(f"rasterize_bwd {what}: max error {worst:.3g} of the row's largest entry{on}, "
        f"{n_live} live pairs, the plain version {plain_ms:.1f} ms")
    return err, n_live, plain_ms


def stage_record(ms, plain_ms, nbytes, nops, library_ms=None) -> dict:
    """The numbers of a kernel record for another mode or input of a kernel
    whose record is filed elsewhere (K8's full mode, K9's field-major
    interface, a kernel on another path's inputs)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def gather_work(records, flat, order, n_live):
    """K9's bytes on its arguments: the output written once, order and flat
    read once at each live sorted position, and each gaussian record that a
    live slot names read once (R floats); and the count of those records."""
    n = int(n_live)
    n_records = int(torch.unique(flat[order[:n]]).numel())
    R = records.shape[1]
    return 4 * R * order.shape[0] + 12 * n + 4 * R * n_records, n_records


@torch.no_grad()
def check_gather_records(args, launches, timer, log, what: str, expect=None):
    """K9 on a path's own arguments (records, flat, order, n_live): equal to
    its plain version bit for bit, and to `expect` (the path's own sorted
    fields) if given; timed, with torch.index_select of the same records
    through the composed index beside it (one PyTorch call of the gather,
    gaussian-major).  Each output is released once compared (at 4k each is
    ~9 GiB).  Returns its kernel record."""
    records, flat, order, n_live = args
    got = gk.gather_records(*args)
    if expect is None:
        expect, got = got, None
    else:
        require(torch.equal(got.view(torch.int32), expect.view(torch.int32)),
                f"gather_records ({what}): a rerun differs from the path's")
        del got
    want = gk.gather_records_plain(*args)
    require(torch.equal(want.view(torch.int32), expect.view(torch.int32)),
            f"gather_records ({what}) != plain")
    del want, expect
    n = int(n_live)
    idx = flat[order[:n]].long()
    library_ms = timer(lambda: torch.index_select(records, 0, idx), 10)
    del idx
    nbytes, n_records = gather_work(*args)
    rec = kernel_record("gather_records", launches["gather_records"], 0.0,
                        timer(lambda: gk.gather_records(*args), 10),
                        timer(lambda: gk.gather_records_plain(*args), 1), nbytes, 0, library_ms)
    log(f"gather_records ({what}): {records.shape[1]} fields (row stride {records.stride(0)}) of "
        f"{n_records} gaussians into {n} live of {order.shape[0]} sorted slots, equal to its "
        f"plain version bit for bit; {rec['ms']:.4f} ms, torch.index_select "
        f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms")
    return rec


class PeakMarks:
    """While installed, each call of the named functions closes an interval
    of a step and starts the next: the peak device memory of the interval
    is kept under "<where it started> to <the function's name>".  `done`
    closes the last one (until the step's end) and logs them all."""

    def __init__(self, on_card: bool, *targets):
        self.on_card, self.peaks, self.saved = on_card, {}, []
        for owner, name in targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        self.since = "step start"

    def _mark(self, name):
        if self.on_card:
            self.peaks[f"{self.since} to {name}"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
        self.since = name

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            self._mark(name)
            return fn(*args, **kw)
        return wrapped

    def done(self, log, key: str):
        self._mark("step end")
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        if self.on_card:
            log(json.dumps({key: self.peaks}))


class Probe:
    """Stands in for `owner.name` while installed: keeps the first call's
    arguments (`first_args`, `first_kw`) and times every call (CUDA events on
    the card, the host clock on the CPU)."""

    def __init__(self, owner, name: str, on_card: bool):
        self.owner, self.name, self.on_card = owner, name, on_card
        self.fn = getattr(owner, name)
        self.first_args = None
        self.first_kw = {}
        self.spans = []
        setattr(owner, name, self)

    def __call__(self, *args, **kw):
        if self.first_args is None:
            self.first_args, self.first_kw = args, kw
        if self.on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.fn(*args, **kw)
            end.record()
            self.spans.append((start, end))
        else:
            t = time.perf_counter()
            out = self.fn(*args, **kw)
            self.spans.append((time.perf_counter() - t) * 1e3)
        return out

    def restore(self):
        setattr(self.owner, self.name, self.fn)

    def total_ms(self) -> float:
        if self.on_card:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.spans)
        return sum(self.spans)


def training_data(raw, viewmats, K, wh):
    """The synthetic scene as the trainer's npz-like mapping: make_splats'
    points and colours, the orbit cameras."""
    colors = raw["sh0"][:, 0, :] * SH_C0 + 0.5
    return dict(means3d=raw["means"], colors=(colors * 255.0).astype(np.float32),
                viewmats=viewmats, Ks=np.tile(K[None], (len(viewmats), 1, 1)),
                width=wh[0], height=wh[1])


def make_trainer(dev, data, n_points: int, steps: int, result_dir: str, cap: int):
    cfg = trainer_mod.Config(
        strategy="mcmc", result_dir=result_dir, max_steps=steps, batch_size=1, sh_degree=3,
        sh_degree_interval=TRAIN_SH_INTERVAL, cap_max=n_points, refine_every=3,
        eval_every=steps, save_every=steps, fixed_batch=True, seed=SEED,
        isect_capacity=cap, row_capacity=cap, opacity_reg=0.01, scale_reg=0.01,
    )
    tr = trainer_mod.Trainer(cfg, data=data, device=dev)
    tr.strategy = dataclasses.replace(tr.strategy, refine_start_iter=1)
    return tr


def size_training_capacities(tr, log) -> int:
    """Size isect_capacity (and the row capacity, set equal) as the serving
    phase does: a pass that may overflow gives the AABB bound, a second pass
    within that bound the exact count.  Both the initial model and the
    targets' opaque cloud are counted over every view; the model gets
    TRAIN_HEADROOM on top, since its splats grow as they train."""
    dev = tr.device
    cfg = tr.cfg

    def counts(render, cap):
        cfg.isect_capacity = cfg.row_capacity = cap
        out = []
        for i in range(len(tr.viewmats)):
            vm = torch.from_numpy(tr.viewmats[i : i + 1]).to(dev)
            K = torch.from_numpy(tr.Ks[i : i + 1]).to(dev)
            with torch.no_grad():
                meta = render(vm, K)[2]
            n_vis = int((meta["radii"] > 0).all(dim=-1).sum())
            if bool(meta["isect_overflow"]):
                out.append(int(meta["tiles_per_gauss"].sum()) + n_vis)
            else:
                out.append(int(meta["n_isects"]) + n_vis)
        return max(out)

    renders = {"model": lambda vm, K: tr.render(tr.params, tr.alive, vm, K, 0)}
    if tr.parser is None:  # rendered targets (npz), not photographs
        target = tr.target_splats()
        renders["targets"] = lambda vm, K: rasterization(
            *target, vm, K, tr.width, tr.height, isect_capacity=cfg.isect_capacity,
            row_capacity=cfg.row_capacity)
    need = {}
    for name, render in renders.items():
        bound = counts(render, 1 << 16)  # overflows: the AABB bound
        need[name] = counts(render, bound + 4096)  # exact
    cap = max(int(need["model"] * TRAIN_HEADROOM), need.get("targets", 0)) + 4096
    cfg.isect_capacity = cfg.row_capacity = cap
    log(f"training capacities: {json.dumps(need)} slots -> isect and rows {cap}")
    return cap


def log_memory(dev, when: str, log) -> None:
    """What the process holds on the card at a phase's start: a step's peak
    counts it too."""
    if dev.type == "cuda":
        log(f"device memory allocated {when}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")


class StepRecorder:
    """While installed on a Trainer, stands in for its `run_step` and
    `update`: one record per step with the step's ms (host clock around
    run_step, ending in a synchronize on the card), its peak device memory,
    loss, alive count, overflow flag and whether every gradient was finite.
    The finiteness check reads every gradient and waits for the card, so its
    own time is taken out of the step's."""

    def __init__(self, tr):
        self.tr, self.records = tr, []
        self.on_card = tr.device.type == "cuda"
        self.run_step, self.update = tr.run_step, tr.update
        tr.run_step, tr.update = self._run_step, self._update

    def restore(self):
        self.tr.run_step, self.tr.update = self.run_step, self.update

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def _update(self, params, opt_state, grads, *rest):
        self._sync()
        t = time.perf_counter()
        self._finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        self._check_ms = (time.perf_counter() - t) * 1e3
        return self.update(params, opt_state, grads, *rest)

    def _run_step(self, *args):
        self._sync()  # no earlier work may land in this step's time
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = self.run_step(*args)
        self._sync()
        ms = (time.perf_counter() - t) * 1e3 - self._check_ms
        peak = torch.cuda.max_memory_allocated() / 2**30 if self.on_card else None
        self.records.append(dict(
            step=out["step"], view=out["view"], sh_degree=out["sh_degree"],
            loss=float(out["loss"]), ms=ms, peak_gib=peak, n_alive=int(self.tr.alive.sum()),
            overflow=bool(out["overflow"]), grads_finite=self._finite,
            refined=out["refined"], reset=out["reset"], noised=out["noised"]))
        return out


def training_phases(dev, raw, viewmats, K, wh, check_wh, n_cell, steps, serving_err, timer, log):
    """Phases 6 to 9.  Returns (the step history, launch counts of train(),
    the K2 (both modes) and K5 records)."""
    W, H = wh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    tr = make_trainer(dev, training_data(raw, viewmats, K, wh), len(raw["means"]), steps, tmp,
                      1 << 16)
    log(f"trainer: {int(tr.alive.sum())} gaussians of capacity {tr.capacity}, "
        f"{len(tr.train_views)} train views at {W}x{H}, set up in {time.perf_counter() - t0:.1f} s")
    size_training_capacities(tr, log)

    t0 = time.perf_counter()
    targets = tr._make_npz_targets()  # rendered once, for train() and the probed steps
    log(f"targets: {tuple(targets.shape)} rendered in {time.perf_counter() - t0:.1f} s")

    # Phase 6: train() with the counts read around it.
    log_memory(dev, "before train()", log)
    recorder = StepRecorder(tr)
    reset_launches()
    t0 = time.perf_counter()
    tr.train(targets=targets)
    launches = read_launches()
    log(f"train(): {time.perf_counter() - t0:.1f} s with eval and checkpoint")
    recorder.restore()
    shutil.rmtree(tmp)
    hist = recorder.records
    for r in hist:
        log("train " + json.dumps(r))
    log("training launches " + json.dumps(launches))
    for name in TRAINING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the training path")
    require(len(hist) == steps >= 6, f"{len(hist)} steps ran, {steps} asked")
    for r in hist:
        require(math.isfinite(r["loss"]), f"step {r['step']}: loss {r['loss']}")
        require(r["grads_finite"], f"step {r['step']}: a gradient is not finite")
        require(not r["overflow"], f"step {r['step']}: isect_overflow")
    first = next(r for r in hist if r["view"] == hist[-1]["view"])
    require(first["step"] < hist[-1]["step"] and hist[-1]["loss"] < first["loss"],
            f"loss on view {first['view']} did not fall: {first['loss']} at step "
            f"{first['step']}, {hist[-1]['loss']} at step {hist[-1]['step']}")
    n0 = len(raw["means"])
    require(all(b["n_alive"] >= a["n_alive"] for a, b in zip(hist, hist[1:]))
            and hist[0]["n_alive"] >= n0, "the alive count fell")
    require(any(r["refined"] for r in hist) and any(r["noised"] for r in hist),
            "no refine or no noise injection ran")
    require(hist[-1]["sh_degree"] == 3, "SH degree 3 was not reached")
    require(all(bool(torch.isfinite(v).all()) for v in tr.params.values()),
            "a parameter is not finite after training")

    # Phase 7: the gradients of a small crop on this device and on the CPU,
    # at the trainer's packed default and on the exact path.
    for packed in (True, False):
        gradient_reference(dev, raw, n_cell, check_wh, log, packed)

    # Phases 8 and 9 on steps taken by hand from the trained state.
    records = training_kernels_and_profile(tr, targets, launches, serving_err, timer, log)
    return hist, launches, records


def gradient_reference(dev, raw, n_cell, check_wh, log, packed: bool) -> None:
    """One forward and backward of the trainer's loss on a small crop, on
    `dev` and on the CPU (plain versions), from the same initial parameters,
    with the packed payload and gradients or without.
    The gradients are sums over pixels and slots taken in another order, and
    the card's exp differs from the CPU's by ulps, which can move a (pixel,
    gaussian) pair across the alpha gate: a band relative to each tensor's
    largest entry g, at most 1% of the entries off by more than 3e-4 g, none
    by more than 5e-2 g.  The gradients of a mean loss are far below 1, so
    this is much tighter than the JAX suite's 3e-4 * max(1, g).  Packed, a
    per-slot gradient a few float32 ulps apart can round to the neighbouring
    bf16 value (2^-8 of it): the JAX suite's pack_grads band, at most 3% of
    the entries off by more than 5e-3 g, none by more than 0.1 g
    (tests/test_rasterize_pallas.py:288-295)."""
    strict, frac, hard = (5e-3, 0.03, 0.1) if packed else (3e-4, 0.01, 5e-2)
    sub = {k: v[: max(n_cell // 8, 1)] for k, v in raw.items()}
    ref_wh = (check_wh[0] // 2, check_wh[1] // 2)
    vms, K = look_at_cameras(sub["means"], 2, *ref_wh)
    data = training_data(sub, vms, K, ref_wh)
    grads = []
    cap = None
    for d in (dev, torch.device("cpu")):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
        tr = make_trainer(d, data, len(sub["means"]), 6, tmp, cap or 1 << 16)
        tr.cfg.pack_payload = tr.cfg.pack_grads = packed
        shutil.rmtree(tmp)
        # The trainer starts isotropic with zero higher bands, where the image
        # depends on neither the quats nor shN and their gradients are
        # rounding noise.  Take the scene's own quats and higher bands and
        # stretch each gaussian by its own axis ratios (at most e each way).
        stretch = np.clip(sub["scales"] - sub["scales"].mean(axis=1, keepdims=True), -1.0, 1.0)
        n = len(sub["means"])
        tr.params["quats"][:n].copy_(torch.from_numpy(sub["quats"]))
        tr.params["scales"][:n].add_(torch.from_numpy(stretch).to(d))
        tr.params["shN"][:n].copy_(torch.from_numpy(sub["shN"]))
        cap = cap or size_training_capacities(tr, log)
        targets = tr._make_npz_targets()
        vm = torch.from_numpy(tr.viewmats[:1]).to(d)
        Kt = torch.from_numpy(tr.Ks[:1]).to(d)
        loss, g, g_screen, _, vis, overflow = tr.train_step(tr.params, tr.alive, vm, Kt,
                                                            targets[:1], 3)
        require(not bool(overflow), "gradient reference: isect_overflow")
        grads.append({**{k: v.cpu() for k, v in g.items()}, "means2d": g_screen.cpu(),
                      "loss": float(loss), "n_vis": int(vis.sum())})
    a, b = grads
    require(abs(a["loss"] - b["loss"]) < 1e-5, f"gradient reference: loss {a['loss']} vs {b['loss']}")
    require(b["n_vis"] > 0, "gradient reference: nothing visible")
    worst, faults = {}, []
    for k in ("means", "quats", "scales", "opacities", "sh0", "shN", "means2d"):
        scale = float(b[k].abs().max())
        require(scale > 0 and bool(torch.isfinite(a[k]).all()), f"gradient reference: {k} degenerate")
        diff = (a[k] - b[k]).abs()
        bad = float((diff > strict * scale).float().mean())
        worst[k] = float(diff.max()) / scale
        if not (bad < frac and worst[k] < hard):
            faults.append(f"{k}: {bad:.4f} of entries over {strict} g, max {worst[k]:.3g} g")
    log(f"gradient reference (packed {packed}): {len(sub['means'])} gaussians at "
        f"{ref_wh[0]}x{ref_wh[1]}, loss {a['loss']:.6f}; max |d| / max |g| " + json.dumps(worst))
    require(not faults, "gradient reference: " + "; ".join(faults))


CHANNELS_D = 64  # channels of the grouped-render check: two launches of each composite


def channels_check(dev, raw, n_cell, check_wh, log) -> None:
    """rasterization() at CHANNELS_D colour channels, which the composites
    take in groups of 32, on `dev` and on the CPU (plain versions): one
    render and the backward of a squared loss on the crop of the gradient
    reference at `check_wh`.  The images within the band of the reference
    crop, the gradients within the exact gradient reference's band; on the
    card, K1 and K2 each launched once per group."""
    sub = {k: v[: max(n_cell // 8, 1)] for k, v in raw.items()}
    W, H = check_wh
    vms, K = look_at_cameras(sub["means"], 1, W, H)
    rng = np.random.default_rng(SEED)
    colors = rng.uniform(0.0, 1.0, (len(sub["means"]), CHANNELS_D)).astype(np.float32)
    tgt = rng.uniform(0.0, 1.0, (1, H, W, CHANNELS_D)).astype(np.float32)
    names = ("means", "quats", "scales", "opacities", "colors")
    outs = []
    for d in (dev, torch.device("cpu")):
        f = lambda x: torch.as_tensor(x, device=d)
        leaves = [f(sub["means"]), f(sub["quats"]), torch.exp(f(sub["scales"])),
                  torch.sigmoid(f(sub["opacities"])), f(colors)]
        leaves = [x.requires_grad_() for x in leaves]
        before = (rk.rasterize_fwd.launches, rk.rasterize_bwd.launches)
        img, alpha, meta = rasterization(*leaves, f(vms), f(K[None]), W, H,
                                         isect_capacity=16 * len(sub["means"]), **RENDER_KW)
        (((img - f(tgt)) ** 2).sum() + 0.3 * alpha.sum()).backward()
        sync(d)
        require(not bool(meta["isect_overflow"]), "channels check: isect_overflow")
        if d.type == "cuda":
            launched = (rk.rasterize_fwd.launches - before[0], rk.rasterize_bwd.launches - before[1])
            require(launched == (2, 2), f"channels check: K1 and K2 launched {launched} times, "
                    f"not once per group of 32 channels")
        outs.append((img.detach().cpu(), alpha.detach().cpu(),
                     {k: x.grad.cpu() for k, x in zip(names, leaves)}))
    (ci, ca, cg), (pi, pa, pg) = outs
    require(ci.shape == (1, H, W, CHANNELS_D) and float(pa.mean()) > 0, "channels check: empty")
    band_close(ci, pi, f"channels check: {CHANNELS_D}-channel image")
    band_close(ca, pa, f"channels check: alphas")
    worst = {}
    for k in names:
        scale = float(pg[k].abs().max())
        diff = (cg[k] - pg[k]).abs()
        worst[k] = float(diff.max()) / scale
        require(scale > 0 and bool(torch.isfinite(cg[k]).all()), f"channels check: {k} degenerate")
        require(float((diff > 3e-4 * scale).float().mean()) < 0.01 and worst[k] < 5e-2,
                f"channels check: gradient of {k} off by {worst[k]:.3g} of its largest entry")
    log(f"channels check: {len(sub['means'])} gaussians, {CHANNELS_D} channels at {W}x{H}, "
        f"render and backward agree with the CPU; max |d| / max |g| " + json.dumps(worst))


def training_kernels_and_profile(tr, targets, launches, serving_err, timer, log):
    """Three more steps, taken by hand through the trainer's own methods with
    probes on the rasterizer's stages: the arguments of K2 in its packed
    modes and each stage's time; one more step with both packed flags off
    for K2's float32 mode and K5; then the kernels against their plain
    versions."""
    probes, stage_state = probe_training_steps(tr, targets, log)
    exact_probes = probe_exact_step(tr, targets)
    with torch.no_grad():
        records = check_and_time_training_kernels(tr, probes, exact_probes, launches,
                                                  serving_err, timer, log)
    if tr.device.type == "cuda":
        profile_training_step(tr, *stage_state, timer, log)
    return records


def probe_exact_step(tr, targets):
    """K2's and K5's arguments in one step with pack_payload and pack_grads
    off (the exact path), from the trained state; the step's gradients are
    dropped."""
    cfg = tr.cfg
    cfg.pack_payload = cfg.pack_grads = False
    probes = {name: Probe(rz, name, tr.device.type == "cuda")
              for name in ("rasterize_bwd", "segment_rowsum")}
    leaves = {k: p.detach().requires_grad_() for k, p in tr.params.items()}
    v = tr.train_views[0]
    vm = torch.from_numpy(tr.viewmats[v : v + 1]).to(tr.device)
    Kv = torch.from_numpy(tr.Ks[v : v + 1]).to(tr.device)
    loss, _ = tr.loss_fn(leaves, tr.alive, vm, Kv, targets[v : v + 1], 3)
    loss.backward()
    for p in probes.values():
        p.restore()
    cfg.pack_payload = cfg.pack_grads = True
    return probes


def probe_training_steps(tr, targets, log):
    dev = tr.device
    on_card = dev.type == "cuda"
    probes = {name: Probe(owner, name, on_card) for owner, name in (
        (rz, "compact_by_depth"), (rz, "make_tight_plan"), (rz, "field_table"),
        (rz, "expand_emission"), (rz, "sort_slots"), (rz, "rasterize_fwd"),
        (rz, "rasterize_bwd"), (rz, "unsort_slots"), (rz, "segment_rowsum"),
        (rz, "unpermute_gaussians"), (trainer_mod, "l1_loss"), (trainer_mod, "ssim_loss"),
        (trainer_mod, "selective_adam_update"),
    )}
    vms = torch.from_numpy(tr.viewmats[tr.train_views]).to(dev)
    Ks = torch.from_numpy(tr.Ks[tr.train_views]).to(dev)
    clock = (lambda: torch.cuda.Event(enable_timing=True)) if on_card else None
    phases = collections.defaultdict(float)
    n_steps = 3
    marks = []
    for i in range(n_steps):
        v = i % len(tr.train_views)
        t = [time.perf_counter()]
        ev = []

        def mark():
            if on_card:
                e = clock()
                e.record()
                ev.append(e)
            else:
                t.append(time.perf_counter())

        mark()
        leaves = {k: p.detach().requires_grad_() for k, p in tr.params.items()}
        loss, meta = tr.loss_fn(leaves, tr.alive, vms[v : v + 1], Ks[v : v + 1],
                                targets[v : v + 1], 3)
        mark()
        loss.backward()
        mark()
        grads = {k: p.grad for k, p in leaves.items()}
        visibility = (meta["radii"] > 0).all(dim=-1).any(dim=0) & tr.alive
        tr.params, tr.opt_state = tr.update(tr.params, tr.opt_state, grads, visibility, 0.01)
        mark()
        moments = (tr.opt_state.mu, tr.opt_state.nu)
        tr.params, moments, tr.alive = tr.strategy.refine(tr.params, moments, tr.alive,
                                                          tr.strategy_state, tr.generator)
        mark()
        tr.params = tr.strategy.inject_noise(tr.params, tr.alive, tr.lrs["means"] * 0.01,
                                             tr.generator)
        mark()
        del leaves, grads, loss, meta
        marks.append(ev if on_card else t[1:])
    if on_card:
        torch.cuda.synchronize()
    for m in marks:
        gaps = ([a.elapsed_time(b) for a, b in zip(m, m[1:])] if on_card
                else [(b - a) * 1e3 for a, b in zip(m, m[1:])])
        for name, ms in zip(("forward + loss", "backward", "Adam", "refine", "noise"), gaps):
            phases[name] += ms / n_steps
    for p in probes.values():
        p.restore()
    ms = {name: p.total_ms() / n_steps for name, p in probes.items()}
    fwd_raster = sum(ms[k] for k in ("compact_by_depth", "make_tight_plan", "field_table",
                                     "expand_emission", "sort_slots", "rasterize_fwd"))
    loss_fwd = ms["l1_loss"] + ms["ssim_loss"]
    bwd_raster = sum(ms[k] for k in ("rasterize_bwd", "unsort_slots", "segment_rowsum",
                                     "unpermute_gaussians"))
    stages = [
        ("forward: projection + SH (rest of forward)", phases["forward + loss"] - fwd_raster - loss_fwd),
        ("forward: compaction sort", ms["compact_by_depth"]),
        ("forward: tight plan (incl. K3)", ms["make_tight_plan"]),
        ("forward: field table", ms["field_table"]),
        ("forward: emission K4", ms["expand_emission"]),
        ("forward: slot sort + spans", ms["sort_slots"]),
        ("forward: composite K1", ms["rasterize_fwd"]),
        ("loss: clip, l1, ssim (forward)", loss_fwd),
        ("backward: K2", ms["rasterize_bwd"]),
        ("backward: unsort to emission order", ms["unsort_slots"]),
        ("backward: K5", ms["segment_rowsum"]),
        ("backward: un-permute", ms["unpermute_gaussians"]),
        ("backward: autograd of loss, projection + SH", phases["backward"] - bwd_raster),
        ("Adam (selective, in place)", phases["Adam"]),
        ("strategy: refine", phases["refine"]),
        ("strategy: noise", phases["noise"]),
        ("sum of one step's stages", sum(phases.values())),
    ]
    for name, v in stages:
        log(json.dumps({"train_stage": name, "ms": v}))
    return probes, (vms, Ks, targets)


def k2_work(args, modes, n_live):
    """K2's bytes (each slot row read once, each gradient row written once,
    four pixel planes read) and operations (K1's replay of every evaluated
    pair, the gradient terms of every live pair) on `args`."""
    fields, bounds = args[0], args[1]
    n_images, W, H = args[2], args[6], args[7]
    n_sorted = int(bounds[-1])
    D = modes["n_channels"] if modes.get("packed") else fields.shape[0] - 6
    out_rows = bf16pair.grad_pack_rows(D) if modes.get("pack_grads") else 6 + D
    pairs = evaluated_pairs(*args[:8], n_channels=D if modes.get("packed") else None)
    nbytes = 4 * ((fields.shape[0] + out_rows) * n_sorted + bounds.shape[0]
                  + 2 * n_images * W * H * (D + 1))
    return pairs, nbytes, K1_FLOP_PER_PAIR * pairs + k2_flop_per_live_pair(D) * n_live


def check_segment_rowsum(args, what: str, timer, log):
    """K5 on a step's own arguments: equal bit for bit to its plain version
    (both add each run serially in slot order, each add a float32 add) and
    to itself on a rerun.  Returns (its output, 0.0, the plain version's ms)."""
    got = sk.segment_rowsum(*args)
    out = []
    plain_ms = timer(lambda: out.append(sk.segment_rowsum_plain(*args)), 1, warm=False)
    require(torch.equal(got, out[0]), f"segment_rowsum ({what}) != plain")
    require(torch.equal(got, sk.segment_rowsum(*args)), f"segment_rowsum ({what}): two runs differ")
    data, bounds = args
    log(f"segment_rowsum ({what}): equal to its plain version bit for bit and on a rerun; "
        f"{data.shape[0]} rows, {bounds.shape[0] - 1} segments, {int(bounds[-1])} slots of "
        f"{data.shape[1]}; runs {json.dumps(run_lengths(bounds))}")
    return got, 0.0, plain_ms


def run_lengths(bounds) -> dict:
    """The segments' runs: mean, longest, and how many exceed 64 slots,
    the runs a lane of K5 loads in more than one round."""
    runs = (bounds[1:] - bounds[:-1]).double()
    return {"mean": float(runs.mean()), "longest": int(runs.max()),
            "over_64": int((runs > 64).sum())}


def segment_reduce_ms(data, bounds, got, timer, log):
    """The time of torch.segment_reduce, the one PyTorch call that computes
    K5's function (used nowhere in the port), on the same data."""
    n_summed = int(bounds[-1])
    data_t = data[:, :n_summed].t().contiguous()
    offsets = bounds.long()
    try:
        lib = torch.segment_reduce(data_t, "sum", offsets=offsets, axis=0)
        e = float((lib.t() - got).abs().max())
        del lib
        ms = timer(lambda: torch.segment_reduce(data_t, "sum", offsets=offsets, axis=0), 5,
                   warm=False)
        log(f"torch.segment_reduce on the same data: {ms:.4f} ms, max |d| to K5 {e:.3g}")
        return ms
    except (RuntimeError, NotImplementedError) as exc:
        log(f"torch.segment_reduce does not run here: {str(exc)[:200]}")
        return None


def check_and_time_training_kernels(tr, probes, exact_probes, launches, serving_err, timer, log):
    """Phase 8: K2 in the trainer's packed modes on the first probed step's
    own arguments, on sampled tiles (PLAIN_TILES: its plain replay of every
    4k tile takes a minute); K2's float32 mode on every tile and K5, on the
    exact step's."""
    on_card = tr.device.type == "cuda"
    W, H = tr.width, tr.height
    k2p_args, k2p_kw = probes["rasterize_bwd"].first_args, probes["rasterize_bwd"].first_kw
    require(k2p_kw.get("packed") and k2p_kw.get("pack_grads"),
            f"the trainer's K2 ran in the mode {k2p_kw}, not packed")
    bounds = k2p_args[1]
    counts = (bounds[1:] - bounds[:-1]).long()
    tiles, _ = sampled_tiles(counts, 1, k2p_args[4], k2p_args[5], W, H, tr.device)
    e2p, n_live_p, plain_p_ms = check_bwd_kernel(
        k2p_args, f"packed, tile {TILE} at {W}x{H} (training step)", log, tol=1e-5, tiles=tiles,
        **k2p_kw)

    k2_args = exact_probes["rasterize_bwd"].first_args
    k5_args = exact_probes["segment_rowsum"].first_args
    require(not exact_probes["rasterize_bwd"].first_kw.get("packed"),
            "the exact step's K2 ran packed")
    e2, n_live, plain_ms = check_bwd_kernel(k2_args, f"tile {TILE} at {W}x{H} (training step)",
                                            log)
    got, e5, k5_plain_ms = check_segment_rowsum(k5_args, "training step", timer, log)

    pairs_p, k2p_bytes, k2p_ops = k2_work(k2p_args, k2p_kw, n_live_p)
    pairs, k2_bytes, k2_ops = k2_work(k2_args, {}, n_live)
    data, seg_bounds = k5_args
    n_seg = seg_bounds.shape[0] - 1
    n_summed = int(seg_bounds[-1])
    k5_bytes = 4 * (data.shape[0] * n_summed + data.shape[0] * n_seg + n_seg + 1)
    log(f"rasterize_bwd packed at {W}x{H}: {pairs_p} pairs evaluated, {n_live_p} live, "
        f"{int(k2p_args[1][-1])} slots; exact: {pairs} pairs evaluated, {n_live} live, "
        f"{int(k2_args[1][-1])} slots; segment_rowsum: {n_summed} slots in {n_seg} segments, "
        f"{data.shape[0]} rows")

    library_ms = segment_reduce_ms(data, seg_bounds, got, timer, log) if on_card else None
    del got

    records = [
        kernel_record("rasterize_bwd_packed", launches["rasterize_bwd_packed"],
                      max(e2p, serving_err["rasterize_bwd_packed"]),
                      timer(lambda: rk.rasterize_bwd(*k2p_args, **k2p_kw), 10, warm=False),
                      plain_p_ms, k2p_bytes, k2p_ops),
        kernel_record("rasterize_bwd", launches["rasterize_bwd"],
                      max(e2, serving_err["rasterize_bwd"]),
                      timer(lambda: rk.rasterize_bwd(*k2_args), 10, warm=False), plain_ms,
                      k2_bytes, k2_ops),
        kernel_record("segment_rowsum", launches["segment_rowsum"], e5,
                      timer(lambda: sk.segment_rowsum(*k5_args), 20, warm=False),
                      k5_plain_ms, k5_bytes, 0, library_ms),
    ]
    records[-1]["runs"] = run_lengths(seg_bounds)
    records[0]["plain_on"] = f"{tiles.numel()} of {counts.shape[0]} tiles"
    return records


def profile_training_step(tr, vms, Ks, targets, timer, log) -> None:
    """Phase 9's trace: one training step without a refine, timed whole and
    traced with torch.profiler."""

    def one_step():
        grads_and = tr.train_step(tr.params, tr.alive, vms[:1], Ks[:1], targets[:1], 3)
        tr.params, tr.opt_state = tr.update(tr.params, tr.opt_state, grads_and[1], grads_and[4], 0.01)
        tr.params = tr.strategy.inject_noise(tr.params, tr.alive, tr.lrs["means"] * 0.01,
                                             tr.generator)

    step_ms = timer(one_step, 3)
    log(json.dumps({"train_stage": "whole step without refine", "ms": step_ms}))
    device_profile(one_step, step_ms, log, "step")


def make_surfel_trainer(dev, data, steps: int, result_dir: str, cap: int):
    """Trainer2DGS with the default strategy at its JAX defaults but for the
    schedule (SURFEL_SCHEDULE), both regularizers from step 0."""
    cfg = trainer2d_mod.Config2DGS(
        result_dir=result_dir, max_steps=steps, batch_size=1, sh_degree=3,
        sh_degree_interval=TRAIN_SH_INTERVAL, eval_every=steps, save_every=steps,
        fixed_batch=True, seed=SEED, isect_capacity=cap, row_capacity=cap,
        normal_start_iter=0, dist_start_iter=0,
    )
    tr = trainer2d_mod.Trainer2DGS(cfg, data=data, device=dev)
    tr.strategy = dataclasses.replace(tr.strategy, **SURFEL_SCHEDULE)
    return tr


class TopologyRecorder:
    """While installed, records the change each call of the strategy's
    duplicate and split makes to the alive count, and the gaussians each
    remove takes out."""

    NAMES = ("duplicate", "split", "remove")

    def __init__(self):
        self.events = []
        self.fns = {n: getattr(strategy_ops, n) for n in self.NAMES}
        for n, fn in self.fns.items():
            setattr(strategy_ops, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            if name == "remove":
                alive, mask = args
                self.events.append((name, int((alive & mask).sum())))
                return fn(*args, **kw)
            before = int(args[2].sum())
            out = fn(*args, **kw)
            self.events.append((name, int(out[2].sum()) - before))
            return out
        return wrapped

    def restore(self):
        for n, fn in self.fns.items():
            setattr(strategy_ops, n, fn)


def surfel_phases(dev, raw, viewmats, K, wh, timer, log, steps: int = SURFEL_STEPS):
    """Phases 10 and 11.  Returns (the step history, launch counts of
    train(), the K8, K9, K6a and K6b records)."""
    W, H = wh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_2dgs_")
    t0 = time.perf_counter()
    tr = make_surfel_trainer(dev, training_data(raw, viewmats, K, wh), steps, tmp, 1 << 16)
    n_planted = len(range(0, len(raw["means"]), PLANT_EVERY))
    tr.params["opacities"][: len(raw["means"]) : PLANT_EVERY] = math.log(
        PLANTED_OPACITY / (1.0 - PLANTED_OPACITY))
    log(f"2dgs trainer: {int(tr.alive.sum())} surfels of capacity {tr.capacity}, "
        f"{n_planted} of them at opacity {PLANTED_OPACITY}, {len(tr.train_views)} train views "
        f"at {W}x{H}, set up in {time.perf_counter() - t0:.1f} s")
    size_training_capacities(tr, log)
    t0 = time.perf_counter()
    targets = tr._make_npz_targets()
    log(f"2dgs targets: {tuple(targets.shape)} rendered in {time.perf_counter() - t0:.1f} s")

    # Phase 10: train() with the counts read around it.
    recorder, topo = StepRecorder(tr), TopologyRecorder()
    renders, evals = [], []
    render_fn, eval_fn = trainer2d_mod.rasterization_2dgs, tr.eval

    def counted_render(*args, **kw):
        out = render_fn(*args, **kw)
        if torch.is_grad_enabled():  # a training step's render, not an eval's
            renders.append((out[6]["n_isects"], out[6]["isect_overflow"]))
        return out

    def recorded_eval(step, *args, **kw):
        psnr, ssim = eval_fn(step, *args, **kw)
        evals.append((kw.get("tag"), psnr))
        return psnr, ssim

    log_memory(dev, "before the 2DGS train()", log)
    trainer2d_mod.rasterization_2dgs, tr.eval = counted_render, recorded_eval
    # the checkpoint at the last step would write the 6x-capacity model and its
    # moments (about 12 GB) to the disk; the CPU tests hold checkpoints
    tr._save = lambda step: None
    reset_launches()
    t0 = time.perf_counter()
    tr.train(targets=targets)
    launches = read_launches()
    log(f"2dgs train(): {time.perf_counter() - t0:.1f} s with eval and checkpoint")
    trainer2d_mod.rasterization_2dgs = render_fn
    del tr.eval, tr._save
    recorder.restore()
    topo.restore()
    shutil.rmtree(tmp)
    hist = recorder.records
    for r, (n_isects, overflow) in zip(hist, renders):
        r.update(n_isects=int(n_isects), slot_overflow=bool(overflow))
        log("train2dgs " + json.dumps(r))
    log("2dgs training launches " + json.dumps(launches))
    for name in SURFEL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the 2DGS training path")
    require(len(hist) == steps == len(renders), f"{len(hist)} 2DGS steps ran, {steps} asked")
    require(any(r["reset"] for r in hist), "no opacity reset ran")
    for r in hist:
        require(math.isfinite(r["loss"]), f"2dgs step {r['step']}: loss {r['loss']}")
        require(r["grads_finite"], f"2dgs step {r['step']}: a gradient is not finite")
        require(not r["overflow"], f"2dgs step {r['step']}: isect_overflow")
    # an opacity reset makes every surfel nearly transparent, so the loss is
    # compared on one view before the first reset
    reset_at = next(r["step"] for r in hist if r["reset"])
    a, b = hist[0], next(r for r in hist[1:] if r["view"] == hist[0]["view"])
    require(b["step"] < reset_at and b["loss"] < a["loss"],
            f"2dgs loss on view {a['view']} did not fall before the first reset: {a['loss']} at "
            f"step {a['step']}, {b['loss']} at step {b['step']}")
    refines = [r for r in hist if r["refined"]]
    require(len(topo.events) == 3 * len(refines) > 0, "the refines were not recorded")
    grown = 0
    for i, r in enumerate(refines):
        (_, dup), (_, spl), (_, rem) = topo.events[3 * i : 3 * i + 3]
        grown += dup + spl
        log(json.dumps({"refine_step": r["step"], "alive_before": r["n_alive"] - dup - spl + rem,
                        "duplicated": dup, "split": spl, "pruned": rem,
                        "alive_after": r["n_alive"]}))
    first_pruned = topo.events[2][1]
    require(grown > 0 and first_pruned >= n_planted,
            f"the refines grew {grown} gaussians and the first pruned {first_pruned} "
            f"({n_planted} planted)")
    require(hist[-1]["sh_degree"] == 3, "SH degree 3 was not reached")
    psnr = dict(evals)
    require(all(math.isfinite(v) for v in psnr.values()), f"2dgs eval PSNR {psnr}")
    log(json.dumps({"2dgs_psnr": psnr}))

    if tr.device.type == "cuda":
        profile_surfel_step(tr, targets, timer, log)
    tr.opt_state = None  # the kernel checks need the model only
    records = surfel_kernels(tr, targets, launches, timer, log)
    return hist, launches, records


def surfel_kernels(tr, targets, launches, timer, log):
    """Phase 11 on one more step's own arguments, captured by probes."""
    on_card = tr.device.type == "cuda"
    dev = tr.device
    stages = {name: Probe(owner, name, on_card) for owner, name in (
        (r2d, "make_emission_plan"), (rz, "expand_emission_aabb"), (r2d, "expand_sort_align"),
        (rz, "gather_records"), (r2d, "rasterize2d_fwd"), (r2d, "rasterize2d_bwd"),
        (r2d, "reduce_slot_grads"), (rz, "segment_rowsum"),
    )}
    vm = torch.from_numpy(tr.viewmats[:1]).to(dev)
    Kt = torch.from_numpy(tr.Ks[:1]).to(dev)
    marks = PeakMarks(on_card, (r2d, "rasterize2d_fwd"), (r2d, "rasterize2d_bwd"),
                      (r2d, "reduce_slot_grads"))
    out = tr.train_step(tr.params, tr.alive, vm, Kt, targets[:1], 3, step=tr.cfg.max_steps)
    marks.done(log, "train2dgs_peak_gib")
    require(not bool(out[5]), "2dgs kernel step: isect_overflow")
    del out
    for p in stages.values():
        p.restore()
    for name, p in stages.items():
        log(json.dumps({"train2dgs_stage": name, "ms": p.total_ms()}))
    # the kernels' own arguments only: reduce_slot_grads' would hold the
    # step's slot gradients (~10 GB at 4k) through the checks
    args = {name: stages[name].first_args for name in (
        "segment_rowsum", "gather_records", "expand_emission_aabb", "rasterize2d_fwd",
        "rasterize2d_bwd")}
    del stages
    if on_card:
        torch.cuda.empty_cache()
    log_memory(dev, "before the 2DGS kernel checks", log)
    return check_surfel_kernels(tr, args, launches, timer, log)


@torch.no_grad()
def check_surfel_kernels(tr, args, launches, timer, log):
    """K5, K9, K8, K6a and K6b on the probed step's arguments, in that order,
    each set of arguments released once checked: the step's slot tables are
    ~10 GB each at 4k."""
    on_card = tr.device.type == "cuda"
    dev = tr.device

    def release():
        if on_card:
            torch.cuda.empty_cache()

    # K5 on the surfel step's slot gradients, timed beside torch.segment_reduce
    k5 = args.pop("segment_rowsum")
    got, _, plain_ms = check_segment_rowsum(k5, "2DGS training step", timer, log)
    library_ms = segment_reduce_ms(*k5, got, timer, log) if on_card else None
    del got
    release()
    data, seg = k5
    n_seg, n_summed = seg.shape[0] - 1, int(seg[-1])
    k5_2dgs = kernel_record(
        "segment_rowsum", launches["segment_rowsum"], 0.0,
        timer(lambda: sk.segment_rowsum(*k5), 10), plain_ms,
        4 * (data.shape[0] * n_summed + data.shape[0] * n_seg + n_seg + 1), 0, library_ms)
    k5_2dgs["runs"] = run_lengths(seg)
    del k5, data, seg
    release()

    records = [k5_2dgs]  # run() files it under the 3DGS step's K5 record

    # K9 and K8 in the path's modes, exact (K9 also equal to the step's own
    # sorted fields); the route they replace follows the K6 checks
    k9, k8 = args.pop("gather_records"), args.pop("expand_emission_aabb")
    rec9 = check_gather_records(k9, launches, timer, log, "2DGS training step",
                                expect=args["rasterize2d_fwd"][0])
    release()
    got = gk.expand_emission_aabb(*k8)
    want = gk.expand_emission_aabb_plain(*k8)
    require(got[3] is None and want[3] is None
            and all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])),
            "expand_emission_aabb (no table) != plain")
    require(torch.equal(got[2], k9[1]), "expand_emission_aabb: the ids differ from the step's")
    n_live_slots = int((got[0] < k8[8]).sum())
    del got, want
    release()
    E, cap = k8[0].shape[0], k8[5]
    k8_ms = timer(lambda: gk.expand_emission_aabb(*k8), 10)
    records.append(kernel_record(
        "expand_emission_aabb", launches["expand_emission_aabb"], 0.0, k8_ms,
        timer(lambda: gk.expand_emission_aabb_plain(*k8), 1), 4 * (6 * E + 1 + 3 * cap), 0))
    rec8 = records[-1]
    records.append(rec9)
    log(f"expand_emission_aabb: {E} surfels, {n_live_slots} live slots of {cap}, equal to its "
        f"plain version bit for bit without its table")
    # K6a: bit for bit on the longest spans and a seeded sample of tiles
    k6a, k6b = args.pop("rasterize2d_fwd"), args.pop("rasterize2d_bwd")
    fields, bounds = k6a[0], k6a[1]
    n_images, tw, th, W, H = k6a[2:7]
    T = bounds.shape[0] - 1
    F = fields.shape[0]
    D = F - 15
    n_sorted = int(bounds[-1])
    # the per-tile pair counts come from the kernel (a CPU rehearsal has none):
    # contributing, evaluated, taken by the exact path, and rejected pairs
    # that the exact path (run on them too) would not have gated
    kept, n_eval, n_exact, unsound = (torch.zeros(T, dtype=torch.int32, device=dev)
                                      for _ in range(4))
    counted = dict(pair_counts=kept, eval_counts=n_eval, exact_counts=n_exact,
                   unsound_counts=unsound) if on_card else {}
    out, t_fin, med = r2k.rasterize2d_fwd(*k6a, **counted)
    n_pairs, n_live, n_exact_pairs = int(n_eval.sum()), int(kept.sum()), int(n_exact.sum())
    require(int(unsound.sum()) == 0,
            f"rasterize2d_fwd: the early reject gated {int(unsound.sum())} pairs that the exact "
            f"path keeps, in {int((unsound > 0).sum())} tiles")
    log(f"rasterize2d_fwd pairs: {n_pairs} evaluated, {n_exact_pairs} "
        f"({n_exact_pairs / max(n_pairs, 1):.4f}) through the exact path, {n_live} contributing, "
        f"0 rejected that the exact path keeps")
    require(torch.equal(out, k6b[9]) and torch.equal(t_fin, k6b[10])
            and torch.equal(med, k6b[11]), "rasterize2d_fwd: a rerun differs from the step's")
    counts = (bounds[1:] - bounds[:-1]).long()
    tiles, on_tiles = sampled_tiles(counts, n_images, tw, th, W, H, dev)
    t1 = time.perf_counter()
    out_p, t_p, med_p = r2k.rasterize2d_fwd_plain(*k6a, tiles=tiles, budget=1 << 26)
    plain_fwd_ms = (time.perf_counter() - t1) * 1e3
    require(torch.equal(out[on_tiles], out_p[on_tiles]) and torch.equal(t_fin[on_tiles], t_p[on_tiles])
            and torch.equal(med[on_tiles], med_p[on_tiles]),
            "rasterize2d_fwd != plain on the sampled tiles")
    del out_p, t_p, med_p, out, t_fin
    log(f"rasterize2d_fwd at {W}x{H}: equal to its plain version bit for bit on {tiles.numel()} "
        f"tiles ({int(counts[tiles].sum())} of {n_sorted} slots, the longest span "
        f"{int(counts.max())}); {n_pairs} pairs evaluated, {n_live} contributing")
    # the bound counts the work the function needs given the early reject;
    # `every_pair_bound_ms` is the earlier yardstick, the exact path on every
    # evaluated pair
    gate_flops = k6_gate_flops(n_exact_pairs, n_eval)
    every_pair_flops = K6A_FLOP_PER_PAIR * n_pairs
    fwd_bytes = 4 * (F * n_sorted + T + 1 + n_images * H * W * (D + 7))
    records.append(kernel_record(
        "rasterize2d_fwd", launches["rasterize2d_fwd"], 0.0,
        timer(lambda: r2k.rasterize2d_fwd(*k6a), 10), plain_fwd_ms, fwd_bytes,
        gate_flops + k6a_flop_per_live_pair(D) * n_live))
    records[-1]["plain_on"] = f"{tiles.numel()} of {T} tiles"
    records[-1]["pairs"] = {"evaluated": n_pairs, "exact": n_exact_pairs, "contributing": n_live,
                            "unsound": int(unsound.sum())}
    records[-1]["every_pair_bound_ms"] = bound_ms(
        fwd_bytes, every_pair_flops + k6a_flop_per_live_pair(D) * n_live)

    # K6b: the live pairs, the rows on the sampled tiles, the median's slot
    live = torch.zeros(T, dtype=torch.int32, device=dev)
    got = r2k.rasterize2d_bwd(*k6b, **(dict(live_counts=live) if on_card else {}))
    require(torch.equal(live, kept), f"rasterize2d_bwd: live pairs differ from the forward's in "
            f"{int((live != kept).sum())} tiles")
    again = r2k.rasterize2d_bwd(*k6b)
    require(torch.equal(got, again), "rasterize2d_bwd: two runs differ")
    del again
    sel = torch.cat([torch.arange(int(bounds[t]), int(bounds[t + 1]), device=dev)
                     for t in tiles.tolist()])
    got = got[:, sel]
    release()
    t1 = time.perf_counter()
    want, n_live_p = r2k.rasterize2d_bwd_plain(*k6b, tiles=tiles, budget=1 << 24)
    plain_bwd_ms = (time.perf_counter() - t1) * 1e3
    require(n_live_p == int(live[tiles].sum()) or not on_card,
            "rasterize2d_bwd: live pairs != plain")
    worst, err6b = rows_close(got, want[:, sel], 1e-4,
                              "rasterize2d_bwd (2DGS training step, sampled tiles)", log)
    del got, want
    release()
    v_med = torch.zeros_like(k6b[7])
    v_med[..., D + 4] = 1.0
    g_med = r2k.rasterize2d_bwd(*k6b[:7], v_med, torch.zeros_like(k6b[8]), *k6b[9:])
    med = k6b[11]
    on = med >= 0
    per_slot = torch.bincount(med[on].long(), minlength=g_med.shape[1]).to(torch.float32)
    depth_row = 11 + D
    require(torch.equal(g_med[depth_row], per_slot) and bool((g_med[:depth_row] == 0).all())
            and bool((g_med[depth_row + 1:] == 0).all()),
            "the median's gradient does not land on one slot per pixel")
    top = max(int(med.max()), n_sorted - 1)
    log(f"rasterize2d_bwd: max error {worst:.3g} of the row's largest entry on the sampled "
        f"tiles, {int(live.sum())} live pairs (= the forward's in every tile); v_median lands "
        f"on one slot for each of {int(on.sum())} pixels; largest sorted position {top} "
        f"({'above' if top >= 1 << 24 else 'below'} 2^24 = {1 << 24})")
    del g_med, v_med, per_slot
    release()
    bwd_bytes = 4 * (2 * F * n_sorted + T + 1 + n_images * H * W * (2 * (D + 5) + 3))
    records.append(kernel_record(
        "rasterize2d_bwd", launches["rasterize2d_bwd"], err6b,
        timer(lambda: r2k.rasterize2d_bwd(*k6b), 5), plain_bwd_ms, bwd_bytes,
        gate_flops + k6b_flop_per_live_pair(D) * n_live))
    records[-1]["plain_on"] = f"{tiles.numel()} of {T} tiles"
    records[-1]["every_pair_bound_ms"] = bound_ms(
        bwd_bytes, every_pair_flops + k6b_flop_per_live_pair(D) * n_live)
    del k6a, k6b, fields, bounds, med
    release()

    # The route K8 and K9 replace, on the same inputs: K8's full mode (the
    # fields copied in emission order) and align_rows through the sort give
    # K9's output bit for bit; each is held to its plain version and timed.
    gathered = gk.gather_records(*k9)
    records9, order9 = k9[0], k9[2]
    full_args = (*k8[:3], records9.t().contiguous(), *k8[4:])
    full = gk.expand_emission_aabb(*full_args)
    bare = gk.expand_emission_aabb(*k8)
    require(all(torch.equal(x, y) for x, y in zip(full[:3], bare[:3])),
            "expand_emission_aabb: the full mode's keys, depths or ids differ")
    del bare
    rows, src = full[3], order9.to(torch.int32)
    aligned = gk.align_rows(rows, src)
    require(torch.equal(aligned.view(torch.int32), gathered.view(torch.int32)),
            "gather_records differs from the field-major route (K8's copy, align_rows)")
    del gathered
    idx = src.long()
    require(bool((idx >= 0).all()) and all(
        torch.equal(aligned[f], gk.align_rows_plain(rows[f : f + 1], src)[0])
        and torch.equal(aligned[f], torch.index_select(rows[f], 0, idx))
        for f in range(rows.shape[0])), "align_rows != plain or torch.index_select")
    del aligned
    release()
    F9, A, R = rows.shape[0], src.shape[0], records9.shape[1]
    k9_old_ms = timer(lambda: gk.align_rows(rows, src), 10)
    rec9["align_rows"] = stage_record(
        k9_old_ms, timer(lambda: gk.align_rows_plain(rows, src), 1),
        4 * (rows.numel() + A + F9 * A), 0, timer(lambda: torch.index_select(rows, 1, idx), 5))
    del rows, src, idx, full
    release()
    want = gk.expand_emission_aabb_plain(*full_args)
    got = gk.expand_emission_aabb(*full_args)
    require(all(torch.equal(x, y) for x, y in zip(got, want)),
            "expand_emission_aabb (full mode) != plain")
    del got, want
    release()
    k8_full_ms = timer(lambda: gk.expand_emission_aabb(*full_args), 10)
    rec8["full_mode"] = stage_record(
        k8_full_ms, timer(lambda: gk.expand_emission_aabb_plain(*full_args), 1),
        4 * (E * (6 + R) + 1 + cap * (3 + R)), 0)
    log(f"gather_records: equal bit for bit to the field-major route, K8's full mode then "
        f"align_rows ({F9} rows x {A} slots; each equal to its plain version, align_rows to "
        f"torch.index_select); the path's emission and gather {rec8['ms'] + rec9['ms']:.3f} ms, "
        f"the field-major route's {k8_full_ms + k9_old_ms:.3f} ms")
    del full_args, k8, k9, records9, order9
    release()
    return records


def profile_surfel_step(tr, targets, timer, log) -> None:
    """One 2DGS training step without a refine, timed whole and traced."""
    vm = torch.from_numpy(tr.viewmats[:1]).to(tr.device)
    Kt = torch.from_numpy(tr.Ks[:1]).to(tr.device)

    def one_step():
        out = tr.train_step(tr.params, tr.alive, vm, Kt, targets[:1], 3, step=tr.cfg.max_steps)
        tr.params, tr.opt_state = tr.update(tr.params, tr.opt_state, out[1], out[4], 0.01)

    step_ms = timer(one_step, 3)
    log(json.dumps({"train2dgs_stage": "whole step without refine", "ms": step_ms,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    device_profile(one_step, step_ms, log, "2dgs_step")


def gut_params(raw, dev):
    """The grid-5 scene's activated parameters as leaves: means, quats,
    scales, opacities, SH coefficients [N, 16, 3]."""
    f = lambda x: torch.as_tensor(x, device=dev)
    colors = np.concatenate([raw["sh0"], raw["shN"]], axis=1)
    return [f(raw["means"]), f(raw["quats"]), torch.exp(f(raw["scales"])),
            torch.sigmoid(f(raw["opacities"])), f(colors)]


def gut_phases(dev, raw, viewmats, K, wh, timer, log):
    """Phases 12 and 13: the 3DGUT render and gradient at full width, then
    K9, K7a and K7b against their plain versions on its own inputs.  Returns
    (launch counts of the render, the K7a and K7b records, K9's record)."""
    W, H = wh
    on_card = dev.type == "cuda"
    params = gut_params(raw, dev)
    vm = torch.as_tensor(viewmats[:1], device=dev)
    Kt = torch.as_tensor(K[None], device=dev)
    kw = dict(GUT_KW, radial_coeffs=torch.tensor([GUT_RADIAL], device=dev))
    with torch.no_grad():  # a pass that overflows gives the AABB slot count
        meta = rasterization(*params, vm, Kt, W, H, isect_capacity=1 << 16, **kw)[2]
    cap = int(meta["tiles_per_gauss"].sum()) + 4096
    log(f"3dgut: {params[0].shape[0]} gaussians at {W}x{H}, radial {GUT_RADIAL}, "
        f"isect_capacity {cap} (the AABB count)")
    del meta
    g = torch.Generator(device=dev).manual_seed(SEED)
    tgt = torch.rand((1, H, W, 4), generator=g, device=dev) * torch.tensor([1, 1, 1, 8.0], device=dev)
    tgt_n = torch.rand((1, H, W, 3), generator=g, device=dev) - 0.5

    def render_and_backward(record=None):
        leaves = [p.detach().requires_grad_() for p in params]
        sync(dev)
        t0 = time.perf_counter()
        img, alpha, meta = rasterization(*leaves, vm, Kt, W, H, isect_capacity=cap, **kw)
        loss = (img - tgt).abs().mean() + (meta["render_normals"] - tgt_n).abs().mean()
        sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        sync(dev)
        t2 = time.perf_counter()
        if record is not None:
            record.update(render_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                          loss=float(loss.detach()), n_isects=int(meta["n_isects"]),
                          overflow=bool(meta["isect_overflow"]),
                          mean_alpha=float(alpha.detach().mean()),
                          grads_finite=all(bool(torch.isfinite(x.grad).all()) for x in leaves),
                          grads_nonzero=all(float(x.grad.abs().max()) > 0 for x in leaves))
        return img, alpha, meta

    log_memory(dev, "before the 3DGUT renders", log)
    reset_launches()
    for i in range(GUT_REPS):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rec = dict(rep=i)
        img, alpha, meta = render_and_backward(rec)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        log("3dgut " + json.dumps(rec))
        require(img.shape == (1, H, W, 4) and meta["render_normals"].shape == (1, H, W, 3),
                "3dgut: output shapes")
        require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(alpha).all()),
                "3dgut: non-finite image")
        require(not rec["overflow"] and rec["mean_alpha"] > 0, "3dgut: overflow or empty image")
        require(rec["grads_finite"] and rec["grads_nonzero"], "3dgut: a gradient is not finite or zero")
        hd = img[0, ..., 3][alpha[0, ..., 0] > 0.9]
        require(hd.numel() > 0 and bool((hd > 0).all()), "3dgut: no positive hit distance")
        del img, alpha, meta
    launches = read_launches()
    log("3dgut launches " + json.dumps(launches))
    for name in EVAL3D_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the 3DGUT path")
    if on_card:
        unit_ms = timer(render_and_backward, 3)
        device_profile(render_and_backward, unit_ms, log, "3dgut_render_and_backward")

    # the kernels' own arguments, from one more render and backward
    probes = {name: Probe(r3d, name, on_card) for name in ("rasterize_eval3d_fwd",
                                                          "rasterize_eval3d_bwd")}
    probes["gather_records"] = Probe(rz, "gather_records", on_card)
    render_and_backward()
    for p in probes.values():
        p.restore()
    args = {name: p.first_args for name, p in probes.items()}
    del probes
    rec9 = check_gather_records(args.pop("gather_records"), launches, timer, log,
                                "3DGUT render")
    if on_card:
        torch.cuda.empty_cache()
    log_memory(dev, "before the eval3d kernel checks", log)
    return launches, check_eval3d_kernels(dev, args, launches, timer, log, "3DGUT render",
                                          one_origin=True), rec9


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def sampled_tiles(counts, n_images, tiles_w, tiles_h, W, H, dev):
    """The tiles with the longest spans and a seeded sample of the others
    (PLAIN_TILES), in order of span; and the mask of their pixels."""
    T = counts.shape[0]
    n_long, n_rand = PLAIN_TILES
    longest = torch.argsort(counts, descending=True)[:n_long]
    rest = torch.ones(T, dtype=torch.bool, device=dev)
    rest[longest] = False
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    others = torch.nonzero(rest)[:, 0].cpu()
    sample = others[torch.randperm(others.numel(), generator=gen)[:n_rand]].to(dev)
    tiles = torch.cat([longest, sample])
    tiles = tiles[torch.argsort(counts[tiles])]  # batches of like spans
    tile_of_pixel = (torch.arange(n_images, device=dev)[:, None, None] * (tiles_w * tiles_h)
                     + (torch.arange(H, device=dev)[None, :, None] // 16) * tiles_w
                     + torch.arange(W, device=dev)[None, None, :] // 16)
    return tiles, torch.isin(tile_of_pixel, tiles)


@torch.no_grad()
def check_eval3d_kernels(dev, args, launches, timer, log, what: str, every_tile: bool = False,
                         one_origin: bool = False):
    """K7a bit for bit and K7b within 1e-5 of each row's largest entry (the
    ray gradients too) against their plain versions on the sampled tiles,
    or on every tile, the live pairs equal in every tile; no pair gated by
    K7a's early reject that the exact path keeps; with `one_origin`, every
    tile on K7a's hoisted route (a global shutter's rays share one origin);
    each kernel timed.  Large outputs are released as the checks go."""
    on_card = dev.type == "cuda"
    k7a, k7b = args["rasterize_eval3d_fwd"], args["rasterize_eval3d_bwd"]
    fields, bounds, rays = k7a[0], k7a[1], k7a[2]
    n_images, tw, th, W, H, hit, normals = k7a[3:10]
    T = bounds.shape[0] - 1
    F = fields.shape[0]
    D = F - 13 - 3 * hit - 3 * normals
    D_out = D + 3 * normals
    n_sorted = int(bounds[-1])
    # the per-tile counts come from the kernel (a CPU rehearsal has none):
    # contributing, evaluated, taken by the exact path, rejected pairs that
    # the exact path (run on them too) would not have gated, one origin
    kept, n_eval, n_exact, unsound, one = (torch.zeros(T, dtype=torch.int32, device=dev)
                                           for _ in range(5))
    counted = dict(pair_counts=kept, eval_counts=n_eval, exact_counts=n_exact,
                   unsound_counts=unsound, one_origin=one) if on_card else {}
    out, t_fin = r3k.rasterize_eval3d_fwd(*k7a, **counted)
    require(torch.equal(out, k7b[12]) and torch.equal(t_fin, k7b[13]),
            "rasterize_eval3d_fwd: a rerun differs from the render's")
    require(int(unsound.sum()) == 0,
            f"rasterize_eval3d_fwd ({what}): the early reject gated {int(unsound.sum())} pairs "
            f"that the exact path keeps, in {int((unsound > 0).sum())} tiles")
    n_one = int(one.sum())
    require(not (on_card and one_origin) or n_one == T,
            f"rasterize_eval3d_fwd ({what}): {T - n_one} of {T} tiles found more than one origin")
    counts = (bounds[1:] - bounds[:-1]).long()
    if every_tile:
        tiles = torch.argsort(counts)  # batches of like spans
        on_tiles = torch.ones((n_images, H, W), dtype=torch.bool, device=dev)
    else:
        tiles, on_tiles = sampled_tiles(counts, n_images, tw, th, W, H, dev)
    t1 = time.perf_counter()
    out_p, t_p = r3k.rasterize_eval3d_fwd_plain(*k7a, tiles=tiles, budget=1 << 26)
    plain_fwd_ms = (time.perf_counter() - t1) * 1e3
    require(torch.equal(out[on_tiles], out_p[on_tiles]) and torch.equal(t_fin[on_tiles], t_p[on_tiles]),
            f"rasterize_eval3d_fwd != plain ({what})")
    del out_p, t_p, out, t_fin
    n_pairs, n_live, n_exact_pairs = int(n_eval.sum()), int(kept.sum()), int(n_exact.sum())
    log(f"rasterize_eval3d_fwd, {what}, at {W}x{H} (hit {hit}, normals {normals}, D {D}): "
        f"equal to its plain version bit for bit on "
        f"{tiles.numel()} tiles ({int(counts[tiles].sum())} of {n_sorted} slots, the longest "
        f"span {int(counts.max())}); {n_pairs} pairs evaluated, {n_exact_pairs} "
        f"({n_exact_pairs / max(n_pairs, 1):.4f}) through the exact path, {n_live} "
        f"contributing, 0 rejected that the exact path keeps; {n_one} of {T} tiles with one "
        f"origin (the hoisted route)")
    pix = n_images * H * W
    # the bound counts the work the function needs given the hoisting and the
    # early reject; `every_pair_bound_ms` is the earlier yardstick, the whole
    # response on every evaluated pair
    fwd_bytes = 4 * (F * n_sorted + T + 1 + pix * (6 + D_out + 1))
    live_flops = k7a_flop_per_live_pair(D, hit, normals) * n_live
    records = [kernel_record(
        "rasterize_eval3d_fwd", launches["rasterize_eval3d_fwd"], 0.0,
        timer(lambda: r3k.rasterize_eval3d_fwd(*k7a), 10), plain_fwd_ms, fwd_bytes,
        k7a_gate_flops(n_exact, n_eval, one) + live_flops)]
    records[-1]["plain_on"] = f"{tiles.numel()} of {T} tiles"
    records[-1]["pairs"] = {"evaluated": n_pairs, "exact": n_exact_pairs, "contributing": n_live,
                            "unsound": int(unsound.sum()), "one_origin_tiles": n_one}
    records[-1]["every_pair_bound_ms"] = bound_ms(fwd_bytes,
                                                  K7A_FLOP_EVERY_PAIR * n_pairs + live_flops)

    live = torch.zeros(T, dtype=torch.int32, device=dev)
    got, got_rays = r3k.rasterize_eval3d_bwd(*k7b, **(dict(live_counts=live) if on_card else {}))
    require(torch.equal(live, kept), f"rasterize_eval3d_bwd: live pairs differ from the "
            f"forward's in {int((live != kept).sum())} tiles")
    again = r3k.rasterize_eval3d_bwd(*k7b)
    require(torch.equal(got, again[0]) and torch.equal(got_rays, again[1]),
            "rasterize_eval3d_bwd: two runs differ")
    del again
    require(bool((got[:, n_sorted:] == 0).all()), "rasterize_eval3d_bwd: tail not zero")
    if hit:
        require(bool((got[13 + 3 + D - 1] == 0).all()), "rasterize_eval3d_bwd: hit row not zero")
    sel = torch.cat([torch.arange(int(bounds[t]), int(bounds[t + 1]), device=dev)
                     for t in tiles.tolist()])
    got = got[:, sel]
    got_rays = got_rays[on_tiles]
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    want, want_rays, n_live_p = r3k.rasterize_eval3d_bwd_plain(*k7b, tiles=tiles, budget=1 << 24)
    plain_bwd_ms = (time.perf_counter() - t1) * 1e3
    require(n_live_p == int(live[tiles].sum()) or not on_card,
            "rasterize_eval3d_bwd: live pairs != plain")
    want = want[:, sel]
    if hit:  # the input hit channel's row is exactly zero in both: held above
        keep = torch.ones(F, dtype=torch.bool, device=dev)
        keep[13 + 3 + D - 1] = False
        got, want = got[keep], want[keep]
    # a row with no cotangent (the lidar's intensity: its loss reads only the
    # hit distance) is zero in the plain version and must be zero in the kernel
    zero = (want == 0).all(dim=1)
    require(bool((got[zero] == 0).all()), f"rasterize_eval3d_bwd ({what}): a row that the plain "
            f"version leaves zero is not zero")
    if bool(zero.any()):
        log(f"rasterize_eval3d_bwd ({what}): rows {torch.nonzero(zero)[:, 0].tolist()} of the "
            f"compared rows are zero in both")
    got, want = got[~zero], want[~zero]
    worst, err7b = rows_close(got, want, 1e-5, f"rasterize_eval3d_bwd ({what})", log)
    worst_r, err_r = rows_close(got_rays.t(), want_rays[on_tiles].t(), 1e-5,
                                f"rasterize_eval3d_bwd ray gradients ({what})", log)
    del got, want, got_rays, want_rays
    if on_card:
        torch.cuda.empty_cache()
    log(f"rasterize_eval3d_bwd, {what}: max error {worst:.3g} of the row's largest entry on "
        f"{tiles.numel()} tiles ({worst_r:.3g} for the ray gradients), {int(live.sum())} live "
        f"pairs (= the forward's in every tile)")
    records.append(kernel_record(
        "rasterize_eval3d_bwd", launches["rasterize_eval3d_bwd"], max(err7b, err_r),
        timer(lambda: r3k.rasterize_eval3d_bwd(*k7b), 5), plain_bwd_ms,
        4 * (2 * F * n_sorted + T + 1 + pix * (6 + 2 * (D_out + 1) + 6)),
        K7A_FLOP_EVERY_PAIR * n_pairs + k7b_flop_per_live_pair(D, F) * n_live))
    records[-1]["plain_on"] = f"{tiles.numel()} of {T} tiles"
    return records


def street_scene(dev):
    """av_trainer.synthetic_scene's layout, AV_SCALE times larger and with
    AV_N gaussians: half on a wall across the road, half on the ground; 3
    cameras along the road at 1920x1280 with synthetic_scene's field of
    view; the lidar at the origin, 64 rows from +2.4 to -17.6 degrees and
    2,650 columns over 360 degrees, spinning clockwise."""
    n, scale = AV_N, AV_SCALE
    rng = np.random.default_rng(SEED)
    h = n // 2
    wall = np.c_[np.full(h, 6.0) + rng.normal(0, 0.05, h), rng.uniform(-4, 4, h),
                 rng.uniform(-1, 2, h)]
    ground = np.c_[rng.uniform(1, 6, n - h), rng.uniform(-4, 4, n - h),
                   np.full(n - h, -1.0) + rng.normal(0, 0.05, n - h)]
    pts = (np.concatenate([wall, ground]) * scale).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    W, H = AV_WH
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for c in range(3):
        viewmats[c, :3, :3] = R
        viewmats[c, :3, 3] = R @ -(np.array([0.0, -1.5 + 1.5 * c, 0.3], np.float32) * scale)
    f = 70.0 * W / 96  # synthetic_scene's 70 px at 96 wide
    Ks = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32), (3, 1, 1))
    lidar = make_lidar(
        np.deg2rad(np.linspace(*LIDAR_ELEV_DEG, LIDAR_ROWS)).astype(np.float32),
        (math.pi - np.arange(LIDAR_COLS) * (2 * math.pi / LIDAR_COLS)).astype(np.float32),
        np.zeros(LIDAR_ROWS, np.float32), SpinningDirection.CLOCKWISE, device=dev)
    return dict(points=pts, rgb=rgb, viewmats=viewmats, Ks=Ks, W=W, H=H, lidar=lidar,
                lidar_viewmats=np.eye(4, dtype=np.float32)[None])


def av_phase(dev, timer, log):
    """Phases 14 and 15: the AV trainer at full width, then K9, K7a and K7b
    against their plain versions on one step's lidar render and K2 on its
    cameras'.  Returns (the launch counts of train(), the K7a and K7b
    records of the lidar's shapes, K9's and K2's records)."""
    on_card = dev.type == "cuda"
    n, steps = AV_N, AV_STEPS
    t0 = time.perf_counter()
    scene = street_scene(dev)
    runner = av_mod.AVRunner(av_mod.Config(max_steps=steps, cap_max=n, seed=SEED), scene,
                             device=dev)
    # The runner's own initial scale is 0.3x the distance to a random other
    # point: at 1M points the scene's size, every gaussian a third of the
    # view.  Here each starts at the points' spacing on the wall and ground.
    spacing = math.sqrt(8 * 3 * AV_SCALE**2 / (n / 2))  # the wall's area over its points
    runner.params["scales"].fill_(math.log(0.5 * spacing))
    lidar = runner.lidar
    log(f"av: {n} gaussians, 3 cameras at {AV_WH[0]}x{AV_WH[1]}, lidar {lidar.n_rows}x"
        f"{lidar.n_columns} over {math.degrees(lidar.fov_horiz_span):.1f} degrees, initial "
        f"scale {0.5 * spacing:.4f}, set up in {time.perf_counter() - t0:.1f} s")

    # the capacity: the AABB slot counts of the cameras and the lidar, with headroom
    cams = runner._tensor(scene["viewmats"])
    Ks = runner._tensor(scene["Ks"])
    lvm = runner._tensor(scene["lidar_viewmats"])
    runner.cfg.isect_capacity = 1 << 16
    with torch.no_grad():
        n_cam = int(runner.render_cams(runner.params, runner.alive, cams, Ks)[2]["tiles_per_gauss"].sum())
        n_lidar = int(runner.render_lidar(runner.params, runner.alive, lvm)[2]["tiles_per_gauss"].sum())
    runner.cfg.isect_capacity = int(1.6 * max(n_cam, n_lidar)) + 4096
    log(f"av capacities: cameras {n_cam}, lidar {n_lidar} AABB slots -> isect_capacity "
        f"{runner.cfg.isect_capacity}")

    records, first_inputs = [], []
    step_fn = runner.train_step

    def recorded_step(inputs):
        first_inputs[:] = first_inputs or [inputs]
        sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, lmeta = step_fn(inputs)
        sync(dev)
        records.append(dict(
            step=len(records), ms=(time.perf_counter() - t) * 1e3, loss=float(loss),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
            lidar_slots=int(lmeta["n_isects"]), lidar_overflow=bool(lmeta["isect_overflow"]),
            lidar_distance_loss=float(lmeta["distance_loss"]),
            lidar_background_loss=float(lmeta["background_loss"])))
        return loss, lmeta

    runner.train_step = recorded_step
    log_memory(dev, "before the AV train()", log)
    reset_launches()
    t0 = time.perf_counter()
    runner.train(log=lambda m: None)
    launches = read_launches()
    log(f"av train(): {time.perf_counter() - t0:.1f} s with the targets")
    del runner.train_step
    for r in records:
        log("av " + json.dumps(r))
    log("av launches " + json.dumps(launches))
    for name in AV_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the AV training path")
    require(len(records) == steps, f"{len(records)} AV steps ran, {steps} asked")
    for r in records:
        require(all(math.isfinite(r[k]) for k in ("loss", "lidar_distance_loss",
                                                   "lidar_background_loss")),
                f"av step {r['step']}: a loss is not finite")
        require(r["lidar_slots"] > 0 and not r["lidar_overflow"],
                f"av step {r['step']}: lidar slots {r['lidar_slots']}, overflow {r['lidar_overflow']}")
    require(records[-1]["loss"] < records[0]["loss"],
            f"av loss did not fall: {records[0]['loss']} -> {records[-1]['loss']}")
    if on_card:  # more steps on the same targets, timed whole and traced
        def one_step():
            step_fn(first_inputs[0])

        step_ms = timer(one_step, 3)
        log(json.dumps({"av_stage": "whole step", "ms": step_ms}))
        device_profile(one_step, step_ms, log, "av_step")

    # the lidar render's kernels (hit channel, no normals, D = 2) on every
    # tile; K9 on the lidar's slots; K2 on the cameras' (float32)
    probes = {name: Probe(r3d, name, on_card) for name in ("rasterize_eval3d_fwd",
                                                          "rasterize_eval3d_bwd")}
    probes.update({name: Probe(rz, name, on_card) for name in ("gather_records",
                                                              "rasterize_bwd", "rasterize_fwd")})
    step_fn(first_inputs[0])
    for p in probes.values():
        p.restore()
    k2_kw = probes["rasterize_bwd"].first_kw
    args = {name: p.first_args for name, p in probes.items()}
    del probes
    sync(dev)
    require(not k2_kw.get("packed") and not k2_kw.get("pack_grads"),
            f"the AV cameras' K2 ran in the mode {k2_kw}, not float32")
    rec9 = check_gather_records(args.pop("gather_records"), launches, timer, log,
                                "AV lidar render")
    rec1 = check_k1_av(args.pop("rasterize_fwd"), launches, timer, log)
    k2 = args.pop("rasterize_bwd")
    counts = (k2[1][1:] - k2[1][:-1]).long()
    tiles, _ = sampled_tiles(counts, k2[2], k2[4], k2[5], k2[6], k2[7], dev)
    e2, n_live, plain_ms = check_bwd_kernel(
        k2, f"tile {k2[3]}, {k2[2]} cameras at {k2[6]}x{k2[7]} (AV step)", log, tiles=tiles)
    _, k2_bytes, k2_ops = k2_work(k2, {}, n_live)
    rec2 = kernel_record("rasterize_bwd", launches["rasterize_bwd"], e2,
                         timer(lambda: rk.rasterize_bwd(*k2), 10), plain_ms, k2_bytes, k2_ops)
    rec2["plain_on"] = f"{tiles.numel()} of {counts.shape[0]} tiles"
    del k2
    records = check_eval3d_kernels(dev, args, launches, timer, log, "AV lidar render",
                                   every_tile=True)
    log("av eval3d kernels " + json.dumps(records))
    return launches, records, rec9, rec2, rec1


def check_k1_av(k1, launches, timer, log):
    """K1 (float32) on an AV step's 3 camera renders, its own path: against
    its plain version on every tile (within 1e-4, as at the serving shape),
    timed, with its bound; the `kernels` line's K1 record carries it as
    `av_check`."""
    fields, bounds, n_images, tile, tw, th, W, H = k1
    t1 = time.perf_counter()
    want = rk.rasterize_fwd_plain(*k1)
    plain_ms = (time.perf_counter() - t1) * 1e3
    got = rk.rasterize_fwd(*k1)
    e = max(float((x - y).abs().max()) for x, y in zip(got, want))
    require(e <= 1e-4, f"rasterize_fwd on the AV cameras: max |d| {e} > 1e-4")
    del got, want
    pairs = evaluated_pairs(*k1)
    D, n_slots = fields.shape[0] - 6, int(bounds[-1])
    rec = kernel_record("rasterize_fwd", launches["rasterize_fwd"], e,
                        timer(lambda: rk.rasterize_fwd(*k1), 20), plain_ms,
                        4 * (fields.shape[0] * n_slots + bounds.shape[0] + n_images * W * H * (D + 1)),
                        K1_FLOP_PER_PAIR * pairs)
    rec["exp_bound_ms"] = exp_bound_ms(pairs)
    log(f"rasterize_fwd on the AV cameras ({n_images} at {W}x{H}, tile {tile}): max |d| {e:.3g}, "
        f"{pairs} pairs evaluated, {rec['ms']:.4f} ms")
    return rec


def exp_bound_ms(pairs: int) -> float:
    """The least time for one exp per evaluated pair on the special-function
    units (16 a clock per SM, 132 SMs at the 1.98 GHz boost clock): a bound
    of K1 beside the float32 rate's, which counts the exp as one operation."""
    return pairs / (16 * 132 * 1.98e9) * 1e3


class Serving:
    """The synthetic scene registered on a Stage, and its request cameras
    (`n_views` of them; `raw`: the scene's parameters when the caller made
    them already)."""

    def __init__(self, dev: torch.device, n_cell: int, grid: int, serve_wh, raw=None,
                 n_views: int = N_VIEWS):
        self.raw = make_splats(n_cell, grid, SEED) if raw is None else raw
        self.gscene = splats_from_numpy(self.raw, device=dev, scene_id="synthetic_grid5")
        self.scene = GaussianInferenceScene.from_gaussian_scene(self.gscene, id=self.gscene.id)
        self.stage = Stage()
        self.stage.add_scene(
            self.gscene, lambda splats, alive=None, **kw: render_scene(self.scene, **kw)
        )
        self.W, self.H = serve_wh
        self.viewmats, self.K = look_at_cameras(self.raw["means"], n_views, *serve_wh)
        self.cap = self.row_cap = 4 * self.scene.num_gaussians

    def request(self, vm, **kw):
        """One request at render_scene's default (the fast path) unless `kw`
        says otherwise (fast=False: the exact path)."""
        return self.stage.render(
            self.gscene.id, viewmat=vm, K=self.K, width=self.W, height=self.H,
            isect_capacity=self.cap, row_capacity=self.row_cap, **RENDER_KW, **kw,
        )

    def size_capacities(self):
        """Warm up on every view and size the capacities so nothing
        overflows: the AABB tile counts (of the exact path; the fast path
        reports none) bound each gaussian's tight slots, each visible
        gaussian adds at most one dummy slot, and row records never
        outnumber slots."""
        bound = 0
        for vm in self.viewmats:
            _, _, meta = self.request(vm, fast=False)
            n_vis = int((meta["radii"] > 0).all(dim=-1).sum())
            if bool(meta["isect_overflow"]):
                bound = max(bound, int(meta["tiles_per_gauss"].sum()) + n_vis)
            else:
                bound = max(bound, int(meta["n_isects"]) + n_vis)
        self.cap = self.row_cap = bound + 4096
        for vm in self.viewmats:  # warm the sized shapes
            self.request(vm)
            self.request(vm, fast=False)


def serve_requests(sv: Serving, dev, log, what: str, **kw):
    """One request per view, the counts set to 0 just before and read just
    after.  Returns (records, images and alphas on the host, the first
    request's projection on the host, launches)."""
    W, H = sv.W, sv.H
    reset_launches()
    serve, images, req0 = [], [], None
    for i, vm in enumerate(sv.viewmats):
        if dev.type == "cuda":
            torch.cuda.synchronize()  # no earlier work may land in this request's time
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        img, alpha, meta = sv.request(vm, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        rec = dict(path=what, request=i, ms=ms, n_isects=int(meta["n_isects"]), peak_gib=peak,
                   mean_alpha=float(alpha.mean()), overflow=bool(meta["isect_overflow"]))
        serve.append(rec)
        if i == 0:  # for the kernel phase's checks, kept on the host
            req0 = {k: meta[k].cpu() for k in ("radii", "means2d", "conics", "depths")}
            req0.update(img=img.cpu(), alpha=alpha.cpu())
        log("serve " + json.dumps(rec))
        require(img.shape == (1, H, W, 3) and alpha.shape == (1, H, W, 1), "image shape")
        require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(alpha).all()),
                f"{what} request {i}: non-finite image")
        require(not rec["overflow"], f"{what} request {i}: isect_overflow")
        require(rec["mean_alpha"] > 0, f"{what} request {i}: empty image")
        images.append((img.cpu(), alpha.cpu()))
        del img, alpha, meta  # the next request's peak holds nothing of this one
    launches = read_launches()
    log(f"{what} launches " + json.dumps(launches))
    return serve, images, req0, launches


def fast_class(a: torch.Tensor, b: torch.Tensor, what: str, log) -> None:
    """The fast path against the exact path: the JAX suite's class for it,
    mean < 5e-3 and 99.9% of the values < 0.05 (tests/test_fast_inference.py:62-68)."""
    diff = (a - b).abs().flatten().double()
    mean = float(diff.mean())
    # the 99.9% quantile from the largest 0.1% (torch.quantile caps its input size)
    k = max(diff.numel() // 1000, 1)
    q999 = float(torch.topk(diff, k).values.min())
    log(f"{what}: mean |d| {mean:.3g}, 99.9% {q999:.3g}, max {float(diff.max()):.3g}")
    require(mean < 5e-3 and q999 < 0.05, f"{what}: mean {mean}, 99.9% {q999}")


def write_colmap_scene(dev, raw, n_cell: int, grid: int, wh, tmp: str, log):
    """The COLMAP phases' scene in `tmp`: the grid scene's COLMAP_VIEWS
    look-at views rendered exactly on the card as PNGs (zlib) in images/,
    and a binary model in sparse/0 with one PINHOLE camera, the views and
    the centre cell's n_cell points with their colours.  Returns (the image
    names, the points)."""
    W, H = wh
    t0 = time.perf_counter()
    sv = Serving(dev, n_cell, grid, wh, raw=raw, n_views=COLMAP_VIEWS)
    sv.size_capacities()
    names = [f"view_{i:02d}.png" for i in range(COLMAP_VIEWS)]
    os.makedirs(os.path.join(tmp, "images"))
    for name, vm in zip(names, sv.viewmats):
        img, _, meta = sv.request(vm, fast=False)
        require(not bool(meta["isect_overflow"]), f"colmap target {name}: isect_overflow")
        rgb = torch.round(torch.clamp(img[0], 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        with open(os.path.join(tmp, "images", name), "wb") as f:
            f.write(encode_png(rgb, level=1))
    c = grid * grid // 2  # the centre cell, offset 0: the base points
    pts = raw["means"][c * n_cell:(c + 1) * n_cell]
    colors = np.clip(raw["sh0"][c * n_cell:(c + 1) * n_cell, 0] * SH_C0 + 0.5, 0.0, 1.0)
    K = sv.K
    cams = {1: dict(model="PINHOLE", width=W, height=H,
                    params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64))}
    write_model_binary(os.path.join(tmp, "sparse", "0"), cams, sv.viewmats, [1] * COLMAP_VIEWS,
                       names, pts, np.round(colors * 255.0).astype(np.uint8))
    del sv
    png_bytes = sum(os.path.getsize(os.path.join(tmp, "images", n)) for n in names)
    log(f"colmap scene: {COLMAP_VIEWS} views at {W}x{H} rendered and written ({png_bytes} PNG "
        f"bytes), {len(pts)} points, in {time.perf_counter() - t0:.1f} s")
    return names, pts


def colmap_phase(dev, raw, n_cell: int, grid: int, wh, log):
    """Phase 16: train from a COLMAP scene written here.  The grid scene
    renders COLMAP_VIEWS look-at views exactly on the card (the targets,
    written as PNGs with zlib); a binary model holds one PINHOLE camera, the
    views and the centre cell's n_cell points with their colours.  Then
    Trainer(Config(data="colmap", save_ply=True)) at its defaults (the
    default strategy, packed payload and gradients) takes COLMAP_STEPS steps
    on the training split (every 8th view left out), evaluates the training
    views and writes the live gaussians as a .ply, which load_checkpoint
    reads back and render_scene serves: bit for bit the image of the
    trainer's own live parameters.  Then phase 17 (addons_phase) on the same
    scene, before it is removed.  Returns the launch counts of the two
    train() calls."""
    W, H = wh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_colmap_")
    names, pts = write_colmap_scene(dev, raw, n_cell, grid, wh, tmp, log)
    t0 = time.perf_counter()
    parser = Parser(tmp, factor=1, normalize=True, test_every=8)
    parse_s = time.perf_counter() - t0
    result_dir = os.path.join(tmp, "result")
    cfg = trainer_mod.Config(
        data="colmap", data_dir=tmp, factor=1, result_dir=result_dir, max_steps=COLMAP_STEPS,
        eval_every=COLMAP_STEPS, save_every=COLMAP_STEPS, save_ply=True,
        sh_degree_interval=TRAIN_SH_INTERVAL, fixed_batch=True, seed=SEED)
    t0 = time.perf_counter()
    tr = trainer_mod.Trainer(cfg, device=dev)
    setup_s = time.perf_counter() - t0
    require(tr.parser.image_names == parser.image_names == names, "colmap views out of order")
    n_train = len(tr.train_views)
    require(n_train == COLMAP_VIEWS - 2 and int(tr.alive.sum()) == len(pts),
            f"colmap trainer: {n_train} training views, {int(tr.alive.sum())} gaussians")
    size_training_capacities(tr, log)
    t0 = time.perf_counter()
    targets = tr.colmap_targets()
    load_s = time.perf_counter() - t0
    require(targets.shape == (n_train, H, W, 3) and float(targets.mean()) > 0,
            f"colmap targets {tuple(targets.shape)}")
    log(json.dumps({"colmap_parse_s": parse_s, "trainer_setup_s": setup_s,
                    "targets_decode_s": load_s, "train_views": n_train,
                    "gaussians": int(tr.alive.sum()), "capacity": tr.capacity}))

    recorder = StepRecorder(tr)
    reset_launches()
    t0 = time.perf_counter()
    tr.train(targets=targets)
    launches = read_launches()
    train_s = time.perf_counter() - t0
    recorder.restore()
    hist = recorder.records
    for r in hist:
        log("colmap_train " + json.dumps(r))
    log("colmap training launches " + json.dumps(launches))
    for name in TRAINING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the colmap training path")
    require(len(hist) == COLMAP_STEPS, f"{len(hist)} colmap steps ran")
    for r in hist:
        require(math.isfinite(r["loss"]) and r["grads_finite"] and not r["overflow"],
                f"colmap step {r['step']}: loss {r['loss']}, finite gradients "
                f"{r['grads_finite']}, overflow {r['overflow']}")
    step = COLMAP_STEPS - 1
    with open(os.path.join(result_dir, "stats", f"eval_step{step:04d}.json")) as f:
        stats = json.load(f)
    require(stats["tag"] == "eval" and all(math.isfinite(stats[k]) for k in (
        "psnr", "ssim", "lpips_proxy", "mem", "ellipse_time")), f"colmap eval {stats}")
    ply = os.path.join(result_dir, "ply", f"point_cloud_{step}.ply")
    peak = max(r["peak_gib"] for r in hist) if dev.type == "cuda" else None
    log(json.dumps({"colmap_eval": {k: stats[k] for k in (
        "psnr", "ssim", "lpips", "lpips_proxy", "n_gs", "mem", "ellipse_time")},
        "train_s": train_s, "step_ms": [r["ms"] for r in hist], "peak_gib": peak,
        "ply_bytes": os.path.getsize(ply)}))

    # The .ply served: bit for bit the image of the trainer's own live rows.
    images = []
    live = {k: v[tr.alive].cpu().numpy() for k, v in tr.params.items()}
    for g in (load_checkpoint(ply, device=dev), splats_from_numpy(live, device=dev)):
        require(g.num_gaussians == stats["n_gs"], "the .ply's gaussians differ from the eval's")
        scene = GaussianInferenceScene.from_gaussian_scene(g, id=g.id)
        img, alpha, meta = render_scene(
            scene, viewmat=tr.viewmats[0], K=tr.Ks[0], width=W, height=H,
            isect_capacity=cfg.isect_capacity, row_capacity=cfg.row_capacity)
        require(not bool(meta["isect_overflow"]) and float(alpha.mean()) > 0,
                "the .ply's render overflowed or is empty")
        images.append((img, alpha))
    require(torch.equal(images[0][0], images[1][0]) and torch.equal(images[0][1], images[1][1]),
            "the .ply's render differs from the trainer's live parameters'")
    log(f"colmap .ply: {stats['n_gs']} gaussians served through load_checkpoint and "
        f"render_scene, bit for bit the trainer's own")
    plain_ms = [r["ms"] for r in hist]
    plain_shn = tr.params["shN"][tr.alive].cpu().numpy()
    del tr, targets, images, scene, g, live, recorder
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # Phase 17 on the same written scene, before it is removed.
    addon_launches = addons_phase(dev, tmp, wh, plain_ms, plain_shn, log)
    shutil.rmtree(tmp)
    return launches, addon_launches


ADDON_STEPS = 6
TRAJ_FRAMES = 8
ADDON_GRADS = ("pose", "bil", "app", "pp")


class AddonStepRecorder(StepRecorder):
    """StepRecorder that also stands in for `update_addons`: per step,
    whether every splat gradient is finite and not all zero, and each
    add-on's gradients finite and not all zero (the pose deltas' row of the
    step's view among them), with the view's row index; the checks' time is
    taken out of the step's."""

    def __init__(self, tr):
        super().__init__(tr)
        self.update_addons = tr.update_addons
        tr.update_addons = self._update_addons
        self.addon_checks = []

    def restore(self):
        super().restore()
        self.tr.update_addons = self.update_addons

    def _update(self, params, opt_state, grads, *rest):
        self._sync()
        t = time.perf_counter()
        self._finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        self._splats_nonzero = any(bool(g.any()) for g in grads.values())
        self._check_ms = (time.perf_counter() - t) * 1e3
        return self.update(params, opt_state, grads, *rest)

    def _update_addons(self, grads):
        self._sync()
        t = time.perf_counter()
        rec = {"splats": (self._finite, self._splats_nonzero)}
        for name in ADDON_GRADS:
            gs = list(grads[name].values()) if isinstance(grads[name], dict) else [grads[name]]
            rec[name] = (all(bool(torch.isfinite(g).all()) for g in gs),
                         any(bool(g.any()) for g in gs))
        rec["pose_rows_nonzero"] = torch.nonzero(grads["pose"].abs().sum(dim=1) > 0)[:, 0].tolist()
        rec["pose_shape"] = tuple(grads["pose"].shape)
        self.addon_checks.append(rec)
        self._check_ms += (time.perf_counter() - t) * 1e3
        return self.update_addons(grads)


def addon_tensors(tr) -> dict:
    """Every add-on parameter of a trainer, by checkpoint key."""
    out = {"pose_deltas": tr.pose_deltas, "bil_grids": tr.bil_grids}
    out.update({f"app_{k}": v for k, v in tr.app_params.items()})
    out.update({f"isp_{k}": v for k, v in tr.ppisp_params.items()})
    return out


def addon_moments(tr) -> dict:
    out = {}
    for p, st in (("app", tr.app_opt_state), ("isp", tr.ppisp_opt_state)):
        out.update({f"{p}_mu_{k}": v for k, v in st.mu.items()})
        out.update({f"{p}_nu_{k}": v for k, v in st.nu.items()})
        out[f"{p}_count"] = st.count
    return out


def card_against_cpu(dev, name, fn, inputs, timer, log):
    """`fn(**inputs)` and the gradient of a seeded cotangent with respect to
    every input, on `dev` and on the CPU: each within 1e-5 of the CPU's
    largest entry (matrix products in float32 on both: a TF32 product would
    miss).  Logs the card's forward and backward ms."""
    results = []
    for d in (dev, torch.device("cpu")):
        leaves = {k: v.detach().to(d).requires_grad_() for k, v in inputs.items()}
        out = fn(**leaves)
        if not results:
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED))
        grads = torch.autograd.grad(out, list(leaves.values()), cot.to(d))
        results.append((out.detach(), dict(zip(leaves, grads))))
    (out, grads), (ref, ref_grads) = results
    errs = {"forward": rel_close(out, ref, f"{name}: card against CPU")}
    for k in inputs:
        errs[k] = rel_close(grads[k], ref_grads[k], f"{name}: d/d{k} card against CPU")
    rec = {"addon": name, "max_rel_err": errs}
    if dev.type == "cuda":
        leaves = {k: v.detach().to(dev).requires_grad_() for k, v in inputs.items()}
        c = cot.to(dev)
        rec["forward_ms"] = timer(lambda: fn(**leaves), 5)
        out = fn(**leaves)
        rec["backward_ms"] = timer(lambda: torch.autograd.grad(out, list(leaves.values()), c,
                                                               retain_graph=True), 5)
    log(json.dumps(rec))


def addons_phase(dev, data_dir: str, wh, plain_ms, plain_shn, log):
    """Phase 17: COLMAP training with every add-on, on phase 16's written
    scene; `plain_ms` and `plain_shn` are phase 16's step times and trained
    shN rows (live, numpy).  Returns the launch counts of train() (K3, K4 packed, K1 packed,
    K2 packed and K5 must be > 0)."""
    on_card = dev.type == "cuda"
    W, H = wh
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    result_dir = os.path.join(data_dir, "result_addons")
    cfg = trainer_mod.Config(
        data="colmap", data_dir=data_dir, factor=1, result_dir=result_dir, max_steps=ADDON_STEPS,
        eval_every=ADDON_STEPS, save_every=ADDON_STEPS, pose_opt=True, pose_noise=1e-3,
        app_opt=True, bilateral_grid=True, ppisp=True, tb_every=1, tb_save_image=True,
        render_traj=True, render_traj_path="interp", traj_frames=TRAJ_FRAMES,
        compression="png", save_ply=True, sh_degree_interval=TRAIN_SH_INTERVAL,
        fixed_batch=True, seed=SEED)
    tr = trainer_mod.Trainer(cfg, device=dev)
    size_training_capacities(tr, log)
    targets = tr.colmap_targets()
    n_train = len(tr.train_views)
    start = {k: v.detach().clone() for k, v in addon_tensors(tr).items()}
    # the parser's normalised poses are similarities, not rigid: the pose
    # chain at zero deltas must give the training cameras back
    vm = torch.from_numpy(tr.viewmats[tr.train_views]).to(dev)
    back = trainer_mod.invert_se3(trainer_mod.apply_pose_deltas(
        trainer_mod.invert_se3(vm), torch.zeros_like(tr.pose_deltas)))
    rel_close(back, vm, "the pose chain at zero deltas", tol=1e-5)

    # the trainer's own prints pass through, and are kept for the checks
    printed = []
    timings = {}

    def timed_method(name):
        method = getattr(tr, name)

        def run(*args, **kw):
            sync(dev)
            t = time.perf_counter()
            out = method(*args, **kw)
            sync(dev)
            timings.setdefault(name, []).append(time.perf_counter() - t)
            if name == "run_compression":
                timings["compression_parts"] = out
            return out
        setattr(tr, name, run)

    for name in ("eval", "_save", "render_traj", "run_compression"):
        timed_method(name)
    recorder = AddonStepRecorder(tr)

    def tee(*args, **kw):
        printed.append(" ".join(str(a) for a in args))
        builtins.print(*args, **kw)

    trainer_mod.print = tee
    reset_launches()
    t0 = time.perf_counter()
    try:
        tr.train(targets=targets)
    finally:
        del trainer_mod.print
        recorder.restore()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    hist = recorder.records
    for r, a in zip(hist, recorder.addon_checks):
        log("addons_train " + json.dumps({**r, "addon_grads": a}))
    log("addons training launches " + json.dumps(launches))
    for name in TRAINING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the add-ons path")
    require(len(hist) == ADDON_STEPS == len(recorder.addon_checks),
            f"{len(hist)} add-on steps ran")
    for r, a in zip(hist, recorder.addon_checks):
        require(math.isfinite(r["loss"]) and not r["overflow"],
                f"add-ons step {r['step']}: loss {r['loss']}, overflow {r['overflow']}")
        for name in ("splats",) + ADDON_GRADS:
            require(a[name] == (True, True), f"add-ons step {r['step']}: {name} gradients "
                    f"(finite, not all zero) = {a[name]}")
        require(a["pose_shape"] == (n_train, 9) and r["view"] in a["pose_rows_nonzero"],
                f"add-ons step {r['step']}: pose gradient {a['pose_shape']}, rows "
                f"{a['pose_rows_nonzero']}, view {r['view']}")
    moved = {k: not torch.equal(v, start[k]) for k, v in addon_tensors(tr).items()}
    for prefix in ("pose_deltas", "bil_grids", "app_", "isp_"):
        require(any(m for k, m in moved.items() if k.startswith(prefix)),
                f"add-on {prefix} did not move in {ADDON_STEPS} steps")
    step = ADDON_STEPS - 1
    peak = max(r["peak_gib"] for r in hist) if on_card else None
    log(json.dumps({"addons_step_ms": [r["ms"] for r in hist], "plain_step_ms": plain_ms,
                    "addons_peak_gib": peak, "train_s": train_s,
                    "eval_s": timings["eval"], "save_s": timings["_save"],
                    "traj_s": timings["render_traj"], "compression_s": timings["run_compression"],
                    "compression_parts_s": timings["compression_parts"],
                    "moved": moved}))

    # The checkpoint, in a fresh trainer on the card: equal bit for bit.
    ckpt = os.path.join(result_dir, f"ckpt_{step}.npz")
    again = trainer_mod.Trainer(dataclasses.replace(
        cfg, ckpt=ckpt, result_dir=os.path.join(data_dir, "result_again"), tb_every=0,
        render_traj=False, compression=""), device=dev)
    for what, got, want in (("params", again.params, tr.params),
                            ("mu", again.opt_state.mu, tr.opt_state.mu),
                            ("nu", again.opt_state.nu, tr.opt_state.nu),
                            ("add-ons", addon_tensors(again), addon_tensors(tr)),
                            ("add-on moments", addon_moments(again), addon_moments(tr))):
        require(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
                f"the checkpoint's {what} differ after loading")
    require(torch.equal(again.alive, tr.alive) and again.start_step == ADDON_STEPS,
            "the checkpoint's alive mask or step differ")
    del again
    log(f"add-ons checkpoint: {os.path.getsize(ckpt)} bytes, loaded bit for bit")

    # Card against CPU on view 0's 4k render: the slice, PPISP, the head.
    vm0 = torch.from_numpy(tr.viewmats[:1]).to(dev)
    K0 = torch.from_numpy(tr.Ks[:1]).to(dev)
    with torch.no_grad():
        img = tr.render(tr.params, tr.alive, vm0, K0, tr.sh_degree_at(step), app=tr.app_params,
                        cam_ids=None)[0][0]
    require(img.shape == (H, W, 3) and bool(torch.isfinite(img).all()), "view 0's render")
    from gsplat_tpu_torch.training import apply_appearance, apply_ppisp, bilateral_slice_image

    zero = torch.zeros(1, dtype=torch.long)
    card_against_cpu(dev, "bilateral_slice_image", lambda grid, rgb: bilateral_slice_image(
        grid, rgb)[0], {"grid": tr.bil_grids[0], "rgb": img}, cuda_timer, log)
    card_against_cpu(dev, "apply_ppisp", lambda img, **pp: apply_ppisp(
        pp, img, zero.to(img.device), zero.to(img.device)),
        {"img": img[None], **tr.ppisp_params}, cuda_timer, log)
    cam_pos = trainer_mod.invert_se3(vm0)[:, :3, 3]
    dirs = tr.params["means"][None] - cam_pos[:, None]
    card_against_cpu(dev, "apply_appearance", lambda features, dirs, **app: apply_appearance(
        app, features, zero.to(dirs.device), dirs, tr.sh_degree_at(step)),
        {"features": tr.params["features"], "dirs": dirs, **tr.app_params}, cuda_timer, log)
    del img, dirs

    # Compression: the planes, the decompression against the cropped and
    # sorted splats, the k-means labels of the card against the CPU's.
    from gsplat_tpu_torch.compression import png_compression as pc

    cdir = os.path.join(result_dir, "compression")
    planes = sorted(os.listdir(cdir))
    require(planes == sorted(["meta.json", "means_l.png", "means_u.png", "quats.png",
                              "scales.png", "opacities.png", "sh0.png", "shN_codebook.npz",
                              "shN_labels.png"]), f"compression wrote {planes}")
    keep = tr.alive
    live = {k: tr.params[k][keep].detach().cpu().numpy()
            for k in ("means", "scales", "quats", "opacities", "sh0", "shN")}
    live["opacities"] = live["opacities"].reshape(-1)
    n_side = int(len(live["means"]) ** 0.5)
    ref = pc.prepare_splats(live, device=dev)
    out = pc.PngCompression().decompress(cdir)
    require(all(len(v) == n_side ** 2 for v in out.values()),
            f"decompressed {[len(v) for v in out.values()]} gaussians, not {n_side ** 2}")
    for k in ("quats", "scales", "opacities", "sh0"):
        r = ref[k].reshape(n_side ** 2, -1)
        half = (r.max(axis=0) - r.min(axis=0)) / 255 / 2
        d = np.abs(out[k].reshape(n_side ** 2, -1) - r)
        require(bool((d <= half + 1e-6 * np.maximum(np.abs(r), 1)).all()),
                f"decompressed {k}: {float((d - half).max())} over half an 8-bit step")
    half = (ref["means"].max(axis=0) - ref["means"].min(axis=0)) / 65535 / 2
    d = np.abs(pc.log_transform(out["means"]) - ref["means"])
    require(bool((d <= half + 1e-6 * np.maximum(np.abs(ref["means"]), 1)).all()),
            f"decompressed means: {float((d - half).max())} over half a 16-bit step (log)")
    # The phase's shN rows are all zero (the appearance head replaces the SH
    # colours, as in the JAX trainer), so the k-means is held to the CPU on
    # phase 16's trained shN rows: the card's run at up to 65,536 centres
    # (timed), then one assignment to its centres on the card and on the CPU
    # (a whole CPU run would take minutes), the share of equal labels.
    shn_zero = not ref["shN"].any()
    shn = plain_shn[: n_side ** 2].reshape(n_side ** 2, -1)
    sync(dev)
    t = time.perf_counter()
    centers, _ = pc._kmeans(shn, 2 ** 16, device=dev)
    card_kmeans_s = time.perf_counter() - t
    xs, cs = torch.from_numpy(shn), torch.from_numpy(centers)
    card_labels = pc._assign(xs.to(dev), cs.to(dev)).cpu()
    t = time.perf_counter()
    cpu_labels = pc._assign(xs, cs)
    cpu_assign_s = time.perf_counter() - t
    with open(os.path.join(cdir, "meta.json")) as f:
        meta = json.load(f)
    comp_bytes = sum(os.path.getsize(os.path.join(cdir, f)) for f in planes)
    ply_bytes = os.path.getsize(os.path.join(result_dir, "ply", f"point_cloud_{step}.ply"))
    t = time.perf_counter()
    perm = pc.sort_splats(pc.prepare_splats(live, use_sort=False, device=dev), "plas",
                          device=dev)["means"]
    plas_s = time.perf_counter() - t
    require(len(perm) == n_side ** 2, "PLAS lost rows")

    # The decompressed splats rendered against the live ones on view 0.
    renders = []
    for splats in (out, live):
        g = splats_from_numpy(splats, device=dev)
        scene = GaussianInferenceScene.from_gaussian_scene(g, id="addons")
        im, alpha, m = render_scene(scene, viewmat=tr.viewmats[0], K=tr.Ks[0], width=W,
                                    height=H, isect_capacity=cfg.isect_capacity,
                                    row_capacity=cfg.row_capacity)
        require(not bool(m["isect_overflow"]) and float(alpha.mean()) > 0,
                "a compression render overflowed or is empty")
        renders.append(torch.clamp(im, 0.0, 1.0))
    mse = float(torch.mean((renders[0] - renders[1]) ** 2))
    log(json.dumps({"compression": {
        "gaussians": n_side ** 2, "bytes": comp_bytes, "ply_bytes": ply_bytes,
        "ratio": ply_bytes / comp_bytes, "psnr_vs_live_db": -10.0 * math.log10(max(mse, 1e-12)),
        "meta_keys": sorted(meta), "phase_shN_all_zero": shn_zero,
        "kmeans_plain_shN": {"rows": len(shn), "k": len(centers), "card_s": card_kmeans_s,
                             "labels_card_eq_cpu": float((card_labels == cpu_labels)
                                                         .double().mean()),
                             "cpu_assign_s": cpu_assign_s},
        "plas_sort_s": plas_s,
        "plane_bytes": {f: os.path.getsize(os.path.join(cdir, f)) for f in planes}}}))
    del renders, out, ref, live

    # The trajectory: interp gives traj_frames // (views - 1) frames a segment.
    frames = sorted(os.listdir(os.path.join(result_dir, "traj")))
    n_frames = max(TRAJ_FRAMES // (n_train - 1), 1) * (n_train - 1)
    require(frames == [f"{i:04d}.png" for i in range(n_frames)],
            f"trajectory frames {frames}, expected {n_frames}")
    for f in frames:
        with open(os.path.join(result_dir, "traj", f), "rb") as fh:
            px = decode_png(fh.read(), f)
        require(px.shape == (H, W, 3) and int(px.max()) > int(px.min()),
                f"trajectory frame {f}: {px.shape}, constant {int(px.min())}")
    # TensorBoard: the event file, or the trainer's note where it is not installed
    if importlib.util.find_spec("tensorboard") is not None:
        events = [f for f in os.listdir(os.path.join(result_dir, "tb"))
                  if f.startswith("events.out.tfevents")]
        require(bool(events), "no TensorBoard event file")
        tb = f"event file {events[0]}"
    else:
        require(any("tensorboard unavailable" in line for line in printed),
                "tensorboard is not installed and the trainer printed no note")
        tb = "not installed: the trainer printed its note"
    # The same steps without TensorBoard: its writer thread checksums each
    # 4k canvas in pure Python (without TensorFlow), which the steps above
    # share the interpreter with.
    recorder = AddonStepRecorder(tr)
    vms = torch.from_numpy(tr.viewmats[tr.train_views]).to(dev)
    Ks = torch.from_numpy(tr.Ks[tr.train_views]).to(dev)
    for i in range(3):
        tr.run_step(ADDON_STEPS + i, np.array([i % n_train]), vms, Ks, targets)
    recorder.restore()
    log(json.dumps({"addons_step_ms_without_tensorboard": [r["ms"] for r in recorder.records],
                    "peak_gib": [r["peak_gib"] for r in recorder.records]}))
    if on_card:  # device time by kernel and the idle share of 3 more such steps
        steps = iter(range(ADDON_STEPS + 3, ADDON_STEPS + 6))

        def one_step():
            i = next(steps)
            tr.run_step(i, np.array([i % n_train]), vms, Ks, targets)

        device_profile(one_step, recorder.records[-1]["ms"], log, "addon_step")
    log(json.dumps({"trajectory": {"frames": len(frames), "seconds": timings["render_traj"]},
                    "tensorboard": tb, "phase_s": time.perf_counter() - t_phase,
                    "phase_peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                       if on_card else None)}))
    return launches


ANALYSIS_KERNELS = ("expand_rows", "expand_emission", "rasterize_fwd", "segment_rowsum",
                    "expand_emission_aabb")
INDICES_WH = (1920, 1080)  # the index lists of one 256-slot batch: 530,841,600 entries
SPARSE_PIXELS = 65_536
TOP_K = 8


def timed(dev, fn):
    """(fn(), ms on the host clock, waiting for the card)."""
    sync(dev)
    t = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def dense_pairs(offsets, n_isects, r0: int, r1: int) -> int:
    """(pixel, slot) pairs the banded walk of rasterize_ref evaluates over
    slots [r0, r1) of each tile's span."""
    bounds = rref._span_bounds(offsets, n_isects)
    return sum((u1 - u0) * TILE * TILE * L for u0, u1, L in
               rref._band_plan(rref._span_counts(bounds, r0, r1), TILE * TILE))


def sparse_pairs(offsets, n_isects, pix, max_range: int) -> int:
    """(pixel, slot) pairs the sparse forward evaluates at pixels `pix` of
    image 0."""
    bounds = rref._span_bounds(offsets, n_isects)
    tw = offsets.shape[-1]
    spans = (pix[:, 0].long() // TILE * tw + pix[:, 1].long() // TILE).to(bounds.device)
    counts = rref._span_counts(bounds, 0, max_range)[spans]
    return sum((u1 - u0) * L for u0, u1, L in rref._band_plan(counts, 1))


def grad_band(a: torch.Tensor, b: torch.Tensor, name: str, strict=3e-4, frac=0.01, hard=5e-2):
    """The gradient reference's band (phase 7): relative to b's largest
    entry g, under `frac` of the entries off by more than strict g, none by
    more than hard g."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    g = float(b.abs().max())
    require(g > 0 and bool(torch.isfinite(a).all()), f"{name}: degenerate gradient")
    diff = (a - b).abs()
    bad, worst = float((diff > strict * g).double().mean()), float(diff.max()) / g
    require(bad < frac and worst < hard, f"{name}: {bad:.4f} over {strict} g, max {worst:.3g} g")
    return worst


def rel_close(a: torch.Tensor, b: torch.Tensor, name: str, tol: float = 1e-5) -> float:
    """max |a - b| within tol of b's largest entry."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max()) / scale
    require(bool(torch.isfinite(a).all()) and err <= tol, f"{name}: {err:.3g} of its scale")
    return err


def analysis_phase(dev, scene, vm, K, wh, cap: int, log):
    """The classic public pipeline and the analysis ops on request 0's
    camera (README: fully_fused_projection -> isect_tiles ->
    isect_offset_encode -> rasterize_to_pixels_ref), at 3840x2160, the
    index lists with accumulate at INDICES_WH, then the losses and colour
    correction on the card against the CPU.  Returns the launch counts
    (set to 0 just before, read just after; K1, K3, K4, K5 and K8 must be
    > 0; the cross-check of the spans runs before the reset)."""
    on_card = dev.type == "cuda"
    W, H = wh
    tw, th = -(-W // TILE), -(-H // TILE)
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    inp = rasterizer_inputs(scene, vm, K, W, H)
    m2, cn, cl, op = inp["means2d"], inp["conics"], inp["colors"], inp["opacities"]
    radii, depths = inp["radii"], inp["depths"]
    E = m2.shape[1]
    # the AABB plan of the 2DGS path on the same inputs, for the spans
    plan = rz.make_emission_plan(m2, radii, TILE, tw, th, 1 << 30)
    n_slots = int(plan.cum_in[-1])
    plan = rz.make_emission_plan(m2, radii, TILE, tw, th, n_slots)
    _, aabb_bounds, _, _ = rz.expand_sort_align(m2.new_zeros((E, 4)), depths.reshape(-1), plan,
                                                n_slots, tw, th, 1)
    stats = {}
    reset_launches()

    # 1. intersection: a sizing pass (capacity 0 emits nothing), then the list
    sizing = isect_tiles(m2, radii, depths, TILE, tw, th, capacity=0)
    n_isects = int(sizing.n_isects)
    (isect, offsets), ms = timed(dev, lambda: (lambda i: (i, isect_offset_encode(
        i.tile_keys, 1, tw, th)))(isect_tiles(m2, radii, depths, TILE, tw, th,
                                              capacity=n_isects)))
    require(not bool(isect.overflow) and int(isect.n_isects) == n_isects, "isect_tiles overflow")
    require(n_isects == int(plan.n_isects), f"n_isects {n_isects} != the AABB plan's "
            f"{int(plan.n_isects)}")
    bounds = rref._span_bounds(offsets, isect.n_isects)
    spans = bounds[1:] - bounds[:-1]
    require(torch.equal(spans, (aabb_bounds[1:] - aabb_bounds[:-1]).long()),
            "isect_tiles spans differ from expand_sort_align's")
    max_range = int(spans.max())
    stats["isect"] = dict(n_isects=n_isects, max_span=max_range, ms=ms,
                          k8_launches=gk.expand_emission_aabb.launches)
    log("analysis isect " + json.dumps(stats["isect"]))
    del plan, aabb_bounds, sizing
    ref_args = (TILE, offsets, isect.flatten_ids, isect.n_isects, max_range)
    pairs = dense_pairs(offsets, isect.n_isects, 0, max_range)

    # 2. the oracle against K1 (rasterize_to_pixels: K3, K4, K1)
    (ref_c, ref_a), ms = timed(dev, lambda: rref.rasterize_to_pixels_ref(
        m2, cn, cl, op, W, H, *ref_args))
    stats["oracle"] = dict(ms=ms, pairs=pairs)
    rgbd = torch.cat([cl, depths[..., None]], dim=-1)  # depth rides as a 4th channel
    (k1_c, k1_a, aux), ms = timed(dev, lambda: rz.rasterize_to_pixels(
        m2, cn, rgbd, op, W, H, radii, depths, cap, tile_size=TILE))
    require(not bool(aux["isect_overflow"]), "rasterize_to_pixels overflow")
    stats["oracle"]["k1_ms"] = ms
    stats["oracle"]["err_colors"] = band_close(ref_c, k1_c[..., :3], "oracle colors against K1")
    stats["oracle"]["err_alphas"] = band_close(ref_a, k1_a, "oracle alphas against K1")
    log("analysis oracle " + json.dumps(stats["oracle"]))

    # 3. the contributing ops
    geo = (m2, cn, op, offsets, isect.flatten_ids, W, H, TILE, isect.n_isects, max_range)
    (counts, acc), ms = timed(dev, lambda: contrib.rasterize_num_contributing_gaussians(*geo))
    band_close(acc[..., None], k1_a, "accumulated alphas against K1")
    K_max = int(counts.max())
    stats["num_contributing"] = dict(ms=ms, max_count=K_max,
                                     mean_count=float(counts.float().mean()))
    (ids, w), ms = timed(dev, lambda: contrib.rasterize_contributing_gaussian_ids(*geo, K_max))
    require(torch.equal((ids >= 0).sum(-1).to(torch.int32), counts), "ids: counts differ")
    band_close(w.sum(-1), acc, "contributing weights against the accumulated alphas")
    stats["contributing_ids"] = dict(ms=ms, gib=(ids.numel() * 8) / 2**30)
    (top_ids, top_w), ms = timed(
        dev, lambda: contrib.rasterize_top_contributing_gaussian_ids(*geo, TOP_K))
    for r0 in range(0, H, 64):  # each selected id is one of the pixel's, with its weight
        hit = (top_ids[:, r0:r0 + 64, :, :, None] == ids[:, r0:r0 + 64, :, None, :])
        same_w = (hit & (top_w[:, r0:r0 + 64, :, :, None] == w[:, r0:r0 + 64, :, None, :]))
        require(bool((same_w.any(-1) | (top_ids[:, r0:r0 + 64] < 0)).all()),
                "top contributors are not a subset of the contributing ids with their weights")
    require(torch.equal((top_ids >= 0).sum(-1), torch.clamp(counts, max=TOP_K).to(torch.int64)),
            "top contributors: counts differ")
    stats["top_contributing"] = dict(ms=ms, k=TOP_K)
    log("analysis contributing " + json.dumps({k: stats[k] for k in (
        "num_contributing", "contributing_ids", "top_contributing")}))
    del ids, w, top_ids, top_w, counts, acc

    # 4. sparse rasterization at seeded pixels, its backward twice, and on the CPU
    g = torch.Generator().manual_seed(SEED)
    pix = torch.stack([torch.randint(0, H, (SPARSE_PIXELS,), generator=g),
                       torch.randint(0, W, (SPARSE_PIXELS,), generator=g)], -1).to(torch.int32)
    img_ids = torch.zeros(SPARSE_PIXELS, dtype=torch.int32)

    def sparse(d):
        leaves = [x.detach().to(d).requires_grad_() for x in (m2, cn, cl, op)]
        c, a = sparse_mod.rasterize_to_pixels_sparse(
            *leaves, pix.to(d), img_ids.to(d), W, H, TILE, offsets.to(d),
            isect.flatten_ids.to(d), isect.n_isects.to(d), max_range)
        ((c * c).sum() + (a * a).sum()).backward()
        return c.detach(), a.detach(), [x.grad for x in leaves]

    (sp_c, sp_a, sp_g), ms = timed(dev, lambda: sparse(dev))
    py, px = pix[:, 0].long().to(dev), pix[:, 1].long().to(dev)
    band_close(sp_c, ref_c[0, py, px], "sparse colors against the oracle")
    band_close(sp_a, ref_a[0, py, px], "sparse alphas against the oracle")
    del ref_c, ref_a
    _, _, again = sparse(dev)
    require(all(torch.equal(x, y) for x, y in zip(sp_g, again)),
            "sparse gradients differ from run to run")
    del again
    (cpu_c, cpu_a, cpu_g), cpu_ms = timed(torch.device("cpu"), lambda: sparse(torch.device("cpu")))
    band_close(sp_c.cpu(), cpu_c, "sparse colors on the CPU")
    worst = {n: grad_band(x, y, f"sparse gradient of {n} against the CPU")
             for n, x, y in zip(("means2d", "conics", "colors", "opacities"), sp_g, cpu_g)}
    stats["sparse"] = dict(ms=ms, cpu_ms=cpu_ms, pixels=SPARSE_PIXELS,
                           pairs=sparse_pairs(offsets, isect.n_isects, pix, max_range),
                           grad_vs_cpu=worst)
    log("analysis sparse " + json.dumps(stats["sparse"]))
    del sp_g, cpu_g, cpu_c, cpu_a

    # 5. the index lists and accumulate, batch by batch, at INDICES_WH
    Wi, Hi = INDICES_WH
    inp_i = rasterizer_inputs(scene, vm, scaled_K(K, Wi / W), Wi, Hi)
    twi, thi = -(-Wi // TILE), -(-Hi // TILE)
    n_i = int(isect_tiles(inp_i["means2d"], inp_i["radii"], inp_i["depths"], TILE, twi, thi,
                          capacity=0).n_isects)
    isect_i = isect_tiles(inp_i["means2d"], inp_i["radii"], inp_i["depths"], TILE, twi, thi,
                          capacity=n_i)
    off_i = isect_offset_encode(isect_i.tile_keys, 1, twi, thi)
    b_i = rref._span_bounds(off_i, isect_i.n_isects)
    n_batches = -(-int((b_i[1:] - b_i[:-1]).max()) // (TILE * TILE))
    k1_i, k1_ia, aux = rz.rasterize_to_pixels(inp_i["means2d"], inp_i["conics"], inp_i["colors"],
                                              inp_i["opacities"], Wi, Hi, inp_i["radii"],
                                              inp_i["depths"], 4 * n_i + 4096, tile_size=TILE)
    require(not bool(aux["isect_overflow"]), f"rasterize_to_pixels overflow at {Wi}x{Hi}")
    render = torch.zeros_like(k1_i)
    alphas = torch.zeros_like(k1_ia)
    geo_i = (inp_i["means2d"], inp_i["conics"], inp_i["opacities"])
    t0, entries, valid = time.perf_counter(), 0, 0
    for b in range(n_batches):
        trans = 1.0 - alphas[..., 0]
        lists = contrib.rasterize_to_indices_in_range(b, b + 1, trans, *geo_i, Wi, Hi, TILE,
                                                      off_i, isect_i.flatten_ids,
                                                      isect_i.n_isects)
        entries, valid = lists[0].numel(), valid + int(lists[3].sum())
        r_b, a_b = contrib.accumulate(*geo_i, inp_i["colors"], *lists, Wi, Hi)
        del lists
        render = render + r_b * trans[..., None]
        alphas = alphas + a_b * trans[..., None]
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    # Each batch resumes a pixel that stopped in an earlier one (its
    # transmittance T > 1e-4 is all the next batch sees), as the JAX
    # function and upstream gsplat's do; K1 stops it for good.  A pixel
    # stops only once T <= 1e-4 / (1 - MAX_ALPHA) = 1e-2, so one whose final
    # T in K1 exceeds that never stopped: there the two agree in the band.
    # Elsewhere they part only after T fell to 1e-2: the batches add at
    # most K1's final T of alpha, and where the carried T = 1 - alpha
    # (float32) puts a stop on the other side of 1e-4 than K1's serial
    # product, lose at most 1e-2 (a flipped stop, rare); colours move at
    # most 1e-2 times the largest colour.
    t_k1 = 1.0 - k1_ia
    never = (t_k1 > 1.01e-2)[..., 0]
    err_c = band_close(render[never], k1_i[never], "indices + accumulate colors (never stopped)")
    err_a = band_close(alphas[never], k1_ia[never], "indices + accumulate alphas (never stopped)")
    stopped = ~never
    extra = (alphas - k1_ia)[stopped][:, 0]
    moved = (render - k1_i).abs().amax(-1)[stopped]
    flipped = float((extra < -3e-5).double().mean())
    cmax = float(inp_i["colors"].max())
    log("analysis indices stopped pixels " + json.dumps({
        "stopped": int(stopped.sum()), "flipped_share": flipped, "min_extra": float(extra.min()),
        "max_extra_minus_t": float((extra - t_k1[stopped][:, 0]).max()),
        "max_colour_move": float(moved.max())}))
    require(bool((extra <= t_k1[stopped][:, 0] + 3e-5).all()) and float(extra.min()) >= -1.01e-2,
            "indices + accumulate: a stopped pixel's alpha left its bounds")
    require(float(moved.max()) <= 1.01e-2 * cmax + 3e-5,
            "indices + accumulate: a stopped pixel's colour left its bound")
    require(flipped < 1e-3, f"indices + accumulate: {flipped} of stopped pixels flipped")
    stats["indices"] = dict(wh=[Wi, Hi], n_isects=n_i, batches=n_batches,
                            entries_per_batch=entries, valid=valid, ms=ms,
                            never_stopped_share=float(never.float().mean()),
                            err_colors=err_c, err_alphas=err_a, flipped_share=flipped,
                            max_resumed_alpha=float(extra.max()))
    log("analysis indices " + json.dumps(stats["indices"]))
    del render, alphas, k1_i, k1_ia, inp_i, isect_i

    # 6. losses and colour correction: the card against the CPU
    gen = torch.Generator().manual_seed(SEED + 1)
    # the depth behind the gaussians: 100 (the far plane) where nothing covers a pixel,
    # so that every disparity is finite
    pred_rgb, pred_d = k1_c[..., :3].detach(), (k1_c[..., 3:4] + (1.0 - k1_a) * 100.0).detach()
    gt_rgb = torch.clamp(pred_rgb.cpu() + 0.05 * torch.randn(pred_rgb.shape, generator=gen),
                         0.0, 1.0)
    gt_d = pred_d.cpu() * torch.empty(pred_d.shape).uniform_(0.5, 1.5, generator=gen)
    mask = (k1_a > 0.5).float()
    sc = scene.get("scales").float()  # activated, as the inference scene keeps them
    n_gs = sc.shape[0]
    dims = torch.full((n_gs, 3), 3.0)
    vis = (radii[0] > 0).all(-1).float()
    loss_in = dict(pred_rgb=pred_rgb, pred_d=pred_d, gt_rgb=gt_rgb, gt_d=gt_d, mask=mask,
                   scales=sc, dens=scene.get("opacities").float(),
                   means=scene.get("means").float(), dims=dims, vis=vis)

    def losses_on(d):
        x = {k: v.detach().to(d) for k, v in loss_in.items()}
        for k in ("pred_rgb", "pred_d", "scales", "dens", "means"):
            x[k].requires_grad_()
        z = x["scales"][:, 2]
        vals = {
            "fused_gaussian_losses": sum(t.sum() for t in losses_mod.fused_gaussian_losses(
                x["scales"], x["dens"], z, x["means"], x["dims"], 0.01, x["vis"])),
            "gaussian_scale_reg": losses_mod.gaussian_scale_reg(x["scales"], x["vis"]),
            "masked_ssim": losses_mod.masked_ssim(x["pred_rgb"], x["gt_rgb"], x["mask"]),
            "depth_l1_loss": losses_mod.depth_l1_loss(x["pred_d"], x["gt_d"]),
            "pearson_depth_loss": losses_mod.pearson_depth_loss(x["pred_d"], x["gt_d"]),
            "total_variation_loss": losses_mod.total_variation_loss(x["pred_rgb"]),
            "color_correct_affine": (color_correct_affine(x["pred_rgb"], x["gt_rgb"]) ** 2).mean(),
        }
        out = {}
        for name, v in vals.items():
            leaves = [x[k] for k in ("pred_rgb", "pred_d", "scales", "dens", "means")]
            grads = torch.autograd.grad(v, leaves, allow_unused=True, retain_graph=True)
            out[name] = (float(v.detach()), [gr.cpu() for gr in grads if gr is not None])
        return out

    got, ms = timed(dev, lambda: losses_on(dev))
    want, cpu_ms = timed(torch.device("cpu"), lambda: losses_on(torch.device("cpu")))
    worst = {}
    for name, (v, grads) in got.items():
        v_cpu, g_cpu = want[name]
        require(math.isfinite(v) and abs(v - v_cpu) <= 1e-5 * max(abs(v_cpu), 1e-12),
                f"{name}: {v} on the card, {v_cpu} on the CPU")
        require(len(grads) == len(g_cpu) > 0, f"{name}: no gradient")
        worst[name] = max([abs(v - v_cpu) / max(abs(v_cpu), 1e-12)]
                          + [rel_close(a, b, f"{name} gradient") for a, b in zip(grads, g_cpu)])
    stats["losses"] = dict(ms=ms, cpu_ms=cpu_ms, worst_rel=worst)
    log("analysis losses " + json.dumps(stats["losses"]))
    launches = read_launches()
    stats["seconds"] = time.perf_counter() - t_phase
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    log("analysis " + json.dumps({"seconds": stats["seconds"], "peak_gib": stats["peak_gib"],
                                  "pairs_4k": pairs}))
    log("analysis launches " + json.dumps(launches))
    for name in ANALYSIS_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the analysis path")
    return launches


def run(dev: torch.device, n_cell: int, grid: int, serve_wh, check_wh, timer, log=print,
        train_steps: int = TRAIN_STEPS):
    """All phases on `dev`; returns the serving records, the training
    history and the `kernels` records."""
    t0 = time.perf_counter()
    sv = Serving(dev, n_cell, grid, serve_wh)
    raw, scene, viewmats, K = sv.raw, sv.scene, sv.viewmats, sv.K
    W, H = serve_wh
    log(f"scene: {scene.num_gaussians} gaussians, SH degree {scene.sh_degree}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    sv.size_capacities()
    cap, row_cap = sv.cap, sv.row_cap
    log(f"capacities: isect {cap}, rows {row_cap}")

    # Serving at render_scene's default, the fast path, then one exact
    # request per view; each path's counts are read right after its requests.
    serve, fast_images, req0, launches = serve_requests(sv, dev, log, "serving")
    for name in SERVING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the serving path")
    serve_exact, exact_images, req0_exact, exact_launches = serve_requests(
        sv, dev, log, "serving_exact", fast=False)
    for name in EXACT_RENDER_KERNELS:
        require(exact_launches[name] > 0,
                f"kernel {name} was not launched on the exact serving path")
    for i, ((fi, fa), (ei, ea)) in enumerate(zip(fast_images, exact_images)):
        fast_class(fi, ei, f"request {i}: fast image against the exact one", log)
        fast_class(fa, ea, f"request {i}: fast alpha against the exact one", log)
    del fast_images, exact_images

    # Reference: a small crop renders on this device and on the CPU alike,
    # on the exact and on the fast path.
    sub = {k: v[: max(n_cell // 8, 1)] for k, v in raw.items()}
    ref_wh = (check_wh[0] // 2, check_wh[1] // 2)
    vm_ref, K_ref = look_at_cameras(sub["means"], 1, *ref_wh)
    for fast in (False, True):
        outs = []
        for d in (dev, torch.device("cpu")):
            s = GaussianInferenceScene.from_gaussian_scene(splats_from_numpy(sub, device=d),
                                                           id="crop")
            c, a, _ = render_scene(s, viewmat=vm_ref[0], K=K_ref, width=ref_wh[0],
                                   height=ref_wh[1], fast=fast,
                                   isect_capacity=4 * len(sub["means"]), **RENDER_KW)
            outs.append((c.cpu(), a.cpu()))
        what = "fast" if fast else "exact"
        band_close(outs[0][0], outs[1][0], f"reference colors ({what})")
        band_close(outs[0][1], outs[1][1], f"reference alphas ({what})")
        require(float(outs[1][1].mean()) > 0, "reference image is empty")
    log(f"reference: {len(sub['means'])} gaussians at {ref_wh[0]}x{ref_wh[1]} agree with the "
        f"CPU, exact and fast")
    channels_check(dev, raw, n_cell, check_wh, log)

    # Kernels against their plain versions, on request 0's own inputs: the
    # stages rerun on its camera must give its projection, plan and image.
    err = {}

    def request0_inputs(packed, req):
        ki = kernel_inputs(scene, viewmats[0], K, W, H, TILE, cap, row_cap, packed)
        for key in ("radii", "means2d", "conics", "depths"):
            require(torch.equal(ki["inp"][key].cpu(), req[key]),
                    f"recomputed {key} differ from request 0")
        got_c, got_t = (x.cpu() for x in ki["out"])
        require(torch.equal(got_c, req["img"])
                and torch.equal((1.0 - got_t)[..., None], req["alpha"]),
                f"the stages rerun on request 0's camera (packed {packed}) do not give its image")
        return ki

    serve_in = request0_inputs(False, req0_exact)
    require(serve_in["n_isects"] == serve_exact[0]["n_isects"], "recomputed n_isects differ")
    got = gk.expand_rows(*serve_in["k3"])
    want = gk.expand_rows_plain(*serve_in["k3"])
    require(all(torch.equal(x, y) for x, y in zip(got, want)), "expand_rows != plain")
    err["expand_rows"] = 0.0
    got = gk.expand_emission(*serve_in["k4"])
    want = gk.expand_emission_plain(*serve_in["k4"])
    require(all(torch.equal(x, y) for x, y in zip(got, want)), "expand_emission != plain")
    err["expand_emission"] = 0.0

    def k1_err(ci, what):
        want = rk.rasterize_fwd_plain(*ci["k1"], **ci["k1_kw"])
        e = max(float((x - y).abs().max()) for x, y in zip(ci["out"], want))
        log(f"rasterize_fwd {what}: max |d| {e:.3g}, {ci['n_slots']} slots")
        if ci["k1_kw"]["packed"]:  # the unpack and the float32 composite: bit for bit
            require(e == 0.0, f"rasterize_fwd packed {what}: max |d| {e} != 0")
        # exp ulps and the order of the colour sums could differ: 1e-4 absolute
        require(e <= 1e-4, f"rasterize_fwd {what}: max |d| {e} > 1e-4")
        return e

    err["rasterize_fwd"] = k1_err(serve_in, f"tile {TILE} at {W}x{H} (serving)")
    serve_pk = request0_inputs(True, req0)
    require(serve_pk["n_isects"] == serve[0]["n_isects"], "recomputed n_isects differ (fast)")
    got = gk.expand_emission(*serve_pk["k4"], **serve_pk["k4_kw"])
    want = gk.expand_emission_plain(*serve_pk["k4"], **serve_pk["k4_kw"])
    require(torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                         want[1].view(torch.int32)),
            "expand_emission packed != plain")
    err["expand_emission_packed"] = 0.0
    del got, want
    err["rasterize_fwd_packed"] = k1_err(serve_pk, f"packed, tile {TILE} at {W}x{H} (serving)")
    err["rasterize_bwd"] = err["rasterize_bwd_packed"] = 0.0
    for ts in (8, 16, 32):
        Kc = scaled_K(K, check_wh[0] / W)
        for packed in (False, True):
            what = f"{'packed, ' if packed else ''}tile {ts} at {check_wh[0]}x{check_wh[1]}"
            ci = kernel_inputs(scene, viewmats[0], Kc, *check_wh, ts, cap, row_cap, packed)
            k1_err(ci, what)
            # K2 on K1's own outputs, with a random cotangent made from the seed
            g = torch.Generator(device=dev).manual_seed(SEED + ts)
            v_pix = torch.randn(ci["out"][0].shape, generator=g, device=dev)
            v_t = torch.randn(ci["out"][1].shape, generator=g, device=dev)
            modes = dict(ci["k1_kw"], pack_grads=packed)
            e, *_ = check_bwd_kernel((*ci["k1"], v_pix, v_t, *ci["out"]), what, log, **modes)
            key = "rasterize_bwd_packed" if packed else "rasterize_bwd"
            err[key] = max(err[key], e)

    # Times at the serving shapes, and the least time the card could take.
    records = []
    for ki, names in ((serve_in, ("expand_rows", "expand_emission", "rasterize_fwd")),
                      (serve_pk, ("expand_emission_packed", "rasterize_fwd_packed"))):
        n_live, n_rows, n_slots = ki["n_live"], ki["n_rows"], ki["n_slots"]
        F = ki["k4"][1].shape[0]  # 6 + D field rows
        D = F - 6
        R = ki["k1"][0].shape[0]  # slot rows the sort moved: F, or the carriers
        pairs = evaluated_pairs(*ki["k1"], n_channels=D if R != F else None)
        k4_bytes = 4 * (6 * n_rows + F * n_live + 1 + (1 + R) * cap)
        k1_work = (4 * (R * n_slots + (ki["k1"][4] * ki["k1"][5] + 1) + W * H * (D + 1)),
                   K1_FLOP_PER_PAIR * pairs)
        work = {"expand_rows": (4 * (16 * n_live + 1 + 5 * row_cap), 0),
                "expand_emission": (k4_bytes, 0), "expand_emission_packed": (k4_bytes, 0),
                "rasterize_fwd": k1_work, "rasterize_fwd_packed": k1_work}
        calls = {"expand_rows": (gk.expand_rows, gk.expand_rows_plain, ki["k3"], {}),
                 "expand_emission": (gk.expand_emission, gk.expand_emission_plain, ki["k4"],
                                     ki["k4_kw"]),
                 "rasterize_fwd": (rk.rasterize_fwd, rk.rasterize_fwd_plain, ki["k1"],
                                   ki["k1_kw"])}
        for name in names:
            fn, plain, args, kw = calls[name.replace("_packed", "")]
            records.append(kernel_record(
                name, launches[name] if name in SERVING_KERNELS else exact_launches[name],
                err[name], timer(lambda: fn(*args, **kw), 20),
                timer(lambda: plain(*args, **kw), 1, warm=False),
                *work[name]))
            if name.startswith("rasterize_fwd"):
                records[-1]["exp_bound_ms"] = exp_bound_ms(pairs)
        log(f"rasterize_fwd{'' if R == F else ' packed'} at {W}x{H}: {pairs} (pixel, slot) "
            f"pairs evaluated, {n_slots} slots")
    del serve_in, serve_pk

    # Profile: each stage of request 0 timed alone (the fast path, then the
    # exact one), then device time by kernel of the fast request.
    times = {}
    for packed in (True, False):
        _, stages = forward_stages(scene, viewmats[0], K, W, H, TILE, cap, row_cap, packed)
        tag = "fast" if packed else "exact"
        t_stages = {f"{tag}: {name}": timer(fn, 10) for name, fn in stages}
        times.update(t_stages)
        times[f"{tag}: sum of stages"] = sum(t_stages.values())
        times[f"{tag}: whole request"] = timer(lambda: sv.request(viewmats[0], fast=packed), 10)
    for name, ms in times.items():
        log(json.dumps({"stage": name, "ms": ms}))
    if dev.type == "cuda":
        device_profile(lambda: sv.request(viewmats[0]), times["fast: whole request"], log,
                       "request")
    del stages

    # The analysis surface on the serving scene: the classic pipeline, the
    # oracle, the contributing ops, sparse rasterization, the index lists.
    analysis_launches = analysis_phase(dev, scene, viewmats[0], K, (W, H), cap, log)
    del sv, scene
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Training: the same points and colours through the trainer.
    history, train_launches, train_records = training_phases(
        dev, raw, viewmats, K, (W, H), check_wh, n_cell, train_steps, err, timer, log)

    # 2DGS training: the same points and colours through the surfel trainer.
    surfel_history, surfel_launches, surfel_records = surfel_phases(
        dev, raw, viewmats, K, (W, H), timer, log)

    # 3DGUT: the same scene through a distorted pinhole, evaluated along rays.
    gut_launches, gut_records, gut_k9 = gut_phases(dev, raw, viewmats, K, (W, H), timer, log)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # The AV trainer: cameras and a spinning lidar on a street scene.
    av_launches, av_records, av_k9, av_k2, av_k1 = av_phase(dev, timer, log)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # Training from a COLMAP scene, with the eval and the .ply served again;
    # then the same scene with every add-on of the trainer.
    colmap_launches, addon_launches = colmap_phase(dev, raw, n_cell, grid, (W, H), log)
    for rec, av_rec in zip(gut_records, av_records):
        rec["max_abs_err"] = max(rec["max_abs_err"], av_rec["max_abs_err"])
        rec["av_check"] = {k: av_rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "plain_on", "pairs",
                                                   "every_pair_bound_ms") if k in av_rec}
    # K9's record is the 2DGS step's; K2's (float32) the AV cameras', its
    # path, with the 4k exact training step's numbers beside it
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for rec in surfel_records:
        if rec["name"] == "gather_records":
            rec["3dgut_check"] = {k: gut_k9[k] for k in keys}
            rec["av_check"] = {k: av_k9[k] for k in keys}
    for rec in records:  # K1 (float32): the 4k exact request's, and its AV path's
        if rec["name"] == "rasterize_fwd":
            rec["av_check"] = {k: av_k1[k] for k in keys + ("exp_bound_ms",)}
            rec["max_abs_err"] = max(rec["max_abs_err"], av_k1["max_abs_err"])
    for i, rec in enumerate(train_records):
        if rec["name"] == "rasterize_bwd":
            av_k2["4k_check"] = {k: rec[k] for k in keys + ("bytes_bound_ms",
                                                             "operations_bound_ms")}
            av_k2["max_abs_err"] = max(av_k2["max_abs_err"], rec["max_abs_err"])
            train_records[i] = av_k2
    k5_2dgs = surfel_records.pop(0)
    require(k5_2dgs["name"] == "segment_rowsum", "the 2DGS step's K5 record is missing")
    for rec in train_records:
        if rec["name"] == "segment_rowsum":
            rec["2dgs_check"] = {k: k5_2dgs[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "runs")}
    records = records + train_records + surfel_records + gut_records
    # each kernel's launches on every path, and on its own path as `launches`
    paths = {"serving": launches, "serving_exact": exact_launches, "training": train_launches,
             "2dgs": surfel_launches, "3dgut": gut_launches, "av": av_launches,
             "colmap": colmap_launches, "addons": addon_launches,
             "analysis": analysis_launches}
    for rec in records:
        rec["launches_by_path"] = {p: counts[rec["name"]] for p, counts in paths.items()}
        rec["launches"] = rec["launches_by_path"][MAIN_PATH[rec["name"]]]
        require(rec["launches"] > 0, f"kernel {rec['name']} was not launched on its path")
    require(sorted(r["name"] for r in records) == sorted(KERNELS), "a kernel has no record")
    return serve + serve_exact, history + surfel_history, records


def device_profile(unit_fn, unit_ms: float, log, unit: str, n: int = 3) -> None:
    """A torch.profiler trace of `n` units of work (requests or training
    steps): device time by kernel, and the device's busy and idle share of
    the traced units' own span (kernel intervals merged where they overlap,
    over the host clock from the first unit's start to the last one's end on
    the card); `unit_ms`, the untraced time of a unit, is logged beside it."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            unit_fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(bool(kernels), "the profiler recorded no device time")
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
    log(json.dumps({f"device_ms_per_{unit}": sum(by_name.values()),
                    f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
                    f"traced_ms_per_{unit}": span_ms / n, f"{unit}_ms": unit_ms,
                    "device_idle_share": 1.0 - busy_us / 1e3 / span_ms,
                    f"kernel_launches_per_{unit}": len(kernels) / n}))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(json.dumps({"kernel": name[:100], f"ms_per_{unit}": ms}))


def ptxas_summary(report: str, keep) -> list:
    """(kernel, registers, spill stores, spill loads) of each entry of an
    `nvcc -Xptxas -v` report whose mangled name passes `keep`."""
    rows, entry, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            if keep(entry):
                rows.append((entry, int(m.group(1)), *spills))
            entry = None
    return rows


def log_registers(log) -> None:
    """Registers and spills of the kernels redesigned last, from the build's
    own nvcc report, and any spill anywhere."""
    for name, keep in (("rasterize_fwd", lambda e: re.search(r"ILi(3|32)E", e)),
                       ("rasterize_eval3d_bwd", lambda e: re.search(r"ILi(1|3|32)E", e)),
                       ("segsum", lambda e: True),
                       ("rasterize_bwd", lambda e: re.search(r"ILi(3|32)E", e)),
                       ("align", lambda e: True),
                       ("rasterize2d_fwd", lambda e: re.search(r"ILi(1|4|32)E", e)),
                       ("rasterize2d_bwd", lambda e: re.search(r"ILi(1|4|19|32)E", e))):
        for entry, regs, st, ld in ptxas_summary(_build.ptxas_report(name), keep):
            log(json.dumps({"ptxas": name, "entry": entry[-60:], "registers": regs,
                            "spill_stores": st, "spill_loads": ld}))
    for name in _build.SOURCE_FLAGS:
        report = _build.ptxas_report(name)
        spilled = [e for e, _, st, ld in ptxas_summary(report, lambda e: True) if st or ld]
        if spilled:
            log(json.dumps({"ptxas": name, "entries_with_spills": len(spilled)}))


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
    log_registers(lambda m: print(m, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain composite's colour sum
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, _, records = run(torch.device("cuda"), N_CELL, GRID, SERVE_WH, CHECK_WH, cuda_timer,
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
