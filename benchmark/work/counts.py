"""The least work a unit of the 3DGS cells needs, and the card's peaks.

Frozen here, so that a change to the program cannot move the yardstick.
The per-pair operation counts are copies of chip_smoke.py's (K1_FLOP_PER_PAIR
and k2_flop_per_live_pair, with their derivations).  What they multiply is
counted on the benchmark's own reference (reference/splat3d.py) on the
benchmark's inputs: the live pairs, (pixel, gaussian) pairs with alpha at
least 1/255 before the pixel stops, and the visible gaussians.  Never the
program's plan, its intersection count or its counters: an implementation
that evaluates more pairs does more than the least work, and one that
skips work raises its share.

Each count is a lower bound on what any implementation of the same
function must do, so a share of a peak computed from it cannot pass 100%
unless the timing leaves out part of the work:
  * operations: the live pairs times the per-pair counts, and the
    per-gaussian, per-pixel and per-parameter counts below, each at most
    what the plainest route takes;
  * bytes: each visible gaussian's fields read once at the packed payload's
    2 bytes a field, and each output plane written once at 4 bytes.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# chip_smoke.py: ~20 float32 operations and one exp per (pixel, slot), to
# decide the pair (its offset, sigma, alpha, the gates, T and the stop)
K1_FLOP_PER_PAIR = 21
PAYLOAD_BYTES_PER_FIELD = 2  # a bf16 half of a bf16-pair carrier


def k1_flop_per_live_pair(D: int) -> int:
    """A live pair's decisions (K1_FLOP_PER_PAIR) and its D colour sums
    (a multiply and an add each)."""
    return K1_FLOP_PER_PAIR + 2 * D


def k2_flop_per_live_pair(D: int) -> int:
    """chip_smoke.py's count of what the backward's function needs for a
    live pair beyond the forward's replay: 29 + 3D float32 operations for
    the gradient terms (w, d, E, 1/(1-alpha), v_alpha, v_sigma, v_op, the
    five geometry terms, D colour terms) and one add into each of the 6+D
    per-slot sums; plus the replay of the pair's forward decisions."""
    return (29 + 3 * D) + (6 + D) + K1_FLOP_PER_PAIR


# Per gaussian projected (every row the camera is asked about): the
# quaternion's rotation (30), the world covariance (30), the camera-frame
# mean (18) and covariance (54 as (Rc M)(Rc M)^T), the Jacobian and the 2D
# covariance (30), its inverse (8): 170; the culling tests are not counted.
PROJECT_FLOP = 170
# Per visible gaussian, SH of degree 3 with D = 3: the direction's norm (8),
# the 16 bases (30), and 16 multiply-adds a channel (96): 134.
SH3_FLOP = 134
# The backward of a chain of operations takes at least as many as its
# forward: one multiply a local derivative.
BACKWARD_FACTOR = 1
# Per pixel and channel: L1 (|a - b| and the sum, 3); SSIM's five blurred
# maps (a, b, a^2, b^2, ab), each two 11-tap passes of a multiply-add
# (5 * 2 * 22 = 220), the three products and the map's formula (12): 235.
LOSS_FLOP_PER_PIXEL_CHANNEL = 235
# Per parameter of a visible row: Adam's two moments (5), the update (5).
ADAM_FLOP_PER_PARAM = 10
PARAMS_PER_GAUSSIAN = 3 + 4 + 3 + 1 + 3 + 45  # SH degree 3


def composite_forward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of one image's composite."""
    ops = live * k1_flop_per_live_pair(D)
    nbytes = visible * (6 + D) * PAYLOAD_BYTES_PER_FIELD + pixels * (D + 1) * 4
    return ops, nbytes


def composite_backward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of one image's composite backward: the payload
    read and the per-gaussian gradients written, the pixel cotangents and
    the final transmittance read."""
    ops = live * k2_flop_per_live_pair(D)
    nbytes = 2 * visible * (6 + D) * PAYLOAD_BYTES_PER_FIELD + pixels * (D + 1) * 4
    return ops, nbytes


# chip_smoke.py: the surfel response per (pixel, slot) on the exact path
# (csrc/surfel.cuh): the two planes' homogeneous rows, their cross product,
# the screen-space filter, the minimum, the exp and alpha
K6A_FLOP_PER_PAIR = 42
SURFEL_FIELDS = 2 + 9 + 1 + 4 + 3  # mean, ray transform, opacity, rgb + depth, normal
SURFEL_OUTPUTS = 4 + 3 + 1 + 1  # rgb + depth, normal, T, distortion


def k6a_flop_per_live_pair(D: int) -> int:
    """chip_smoke.py: a live pair's weight, its D + 3 channel sums,
    distortion, A, B and the median test."""
    return 2 * (D + 3) + 10


def k6b_flop_per_live_pair(D: int) -> int:
    """chip_smoke.py: what K6b's function needs for a live pair beyond the
    replay: the channel chain (2(D+3) + 10), the distortion chain (20),
    alpha to sigma and opacity (4), the 3D branch's cross-product transposes
    and the ray transform rows (48, the larger branch), D + 3 channel
    gradients, and one add into each of the 15 + D per-slot sums."""
    return (2 * (D + 3) + 10) + 20 + 4 + 48 + (D + 3) + (15 + D)


def surfel_forward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of one image's surfel composite (float32 fields)."""
    ops = live * (K6A_FLOP_PER_PAIR + k6a_flop_per_live_pair(D))
    nbytes = visible * SURFEL_FIELDS * 4 + pixels * SURFEL_OUTPUTS * 4
    return ops, nbytes


def surfel_backward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of its backward: the replay's decisions and the
    gradient terms of each live pair; the fields read and their gradients
    written, the output planes' cotangents read."""
    ops = live * (K6A_FLOP_PER_PAIR + k6b_flop_per_live_pair(D))
    nbytes = 2 * visible * SURFEL_FIELDS * 4 + pixels * SURFEL_OUTPUTS * 4
    return ops, nbytes


COMPOSITES = {"3dgs": (composite_forward, composite_backward),
              "2dgs": (surfel_forward, surfel_backward)}


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def request_flops(w: dict) -> float:
    """A render's operations: projection of every gaussian, SH of the
    visible ones, the composite of the unit's model ("3dgs" or "2dgs")."""
    forward = COMPOSITES[w["model"]][0]
    return (w["gaussians"] * PROJECT_FLOP + w["visible"] * SH3_FLOP
            + forward(w["live"], w["visible"], w["pixels"], w["channels"])[0])


def step_flops(w: dict) -> float:
    """A training step's operations: the render's, their backward, the
    colour loss (3 channels) forward and backward, and Adam on the visible
    rows; the surfel step's normal and distortion terms are not counted."""
    backward = COMPOSITES[w["model"]][1]
    fwd = request_flops(w)
    bwd = ((w["visible"] * (PROJECT_FLOP + SH3_FLOP)) * BACKWARD_FACTOR
           + backward(w["live"], w["visible"], w["pixels"], w["channels"])[0])
    loss = 2 * w["pixels"] * 3 * LOSS_FLOP_PER_PIXEL_CHANNEL
    adam = w["visible"] * PARAMS_PER_GAUSSIAN * ADAM_FLOP_PER_PARAM
    return fwd + bwd + loss + adam
