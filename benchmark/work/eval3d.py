"""The least work a step of the 3DGUT cells needs: the unscented
projection, the ray composite (K7a) and its backward (K7b).

Frozen here, as work/counts.py, so that a change to the program cannot move
the yardstick.  The per-pair counts are copies of chip_smoke.py's
(K7A_FLOP_PER_PAIR, k7a_flop_per_live_pair and k7b_flop_per_live_pair, with
their derivations), kept to the terms an RGB render without the hit
distance, the normals or ray gradients needs.  What they multiply is counted
on the benchmark's own reference (reference/gut3d.py) on the benchmark's
inputs: the live pairs ((pixel, gaussian) pairs with alpha at least 1/255,
in front of the ray's origin, before the pixel stops), the visible
gaussians and the pixels.  Never the program's plan, its evaluated pairs or
its counters: a share of a peak computed from these lower bounds cannot pass
100% unless the timing leaves out part of the work.
"""

from __future__ import annotations

from . import counts

# chip_smoke.py: csrc/ray3d.cuh's exact path per (pixel, slot) with
# g = M o - M x hoisted (one origin): u = M d (15), |u|^2 (5), its square
# root and reciprocal (2), u^ (3), c = u^ x g (9), gray (5), hit_t (6), the
# exp and its argument (2), alpha (1)
K7A_FLOP_PER_PAIR = 48
RAY_FLOATS = 6  # origin, direction


def fields(D: int) -> int:
    """A slot's float32 rows: x (3), M (9), opacity, D colours."""
    return 13 + D


def k7a_flop_per_live_pair(D: int) -> int:
    """chip_smoke.py: a live pair's weight and its D colour sums (the hit
    distance's 12 and the flipped normal's 12 are not rendered here)."""
    return 1 + 2 * D


def k7b_flop_per_live_pair(D: int) -> int:
    """chip_smoke.py's count of what K7b's function needs for a live pair
    beyond the replay, without what this render does not ask for (the
    normals' 15, the hit distance's 22, hit_t's 12 and the six ray
    gradients' 36): the channel chain (2D), E, 1/(1-alpha) and v_alpha (10),
    v_sigma, v_op and v_c (6), the two cross-product transposes (18), the
    normalization (14), the nine v_M terms (27), and one add into each of
    the 13 + D per-slot sums."""
    return 2 * D + 10 + 6 + 18 + 14 + 27 + fields(D)


def composite_forward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of one image's ray composite: the live pairs'
    responses and sums; each visible gaussian's fields read once, each
    pixel's ray read and its D colours and T written once."""
    ops = live * (K7A_FLOP_PER_PAIR + k7a_flop_per_live_pair(D))
    nbytes = visible * fields(D) * 4 + pixels * (RAY_FLOATS + D + 1) * 4
    return ops, nbytes


def composite_backward(live: int, visible: int, pixels: int, D: int):
    """(operations, bytes) of its backward: the replay of each live pair's
    response and its gradient terms; the fields read and their gradients
    written, each pixel's ray, its D + 1 cotangents and its T read."""
    ops = live * (K7A_FLOP_PER_PAIR + k7b_flop_per_live_pair(D))
    nbytes = 2 * visible * fields(D) * 4 + pixels * (RAY_FLOATS + D + 2) * 4
    return ops, nbytes


# Per gaussian projected through the unscented transform (every row the
# camera is asked about): the quaternion's rotation (30, as
# counts.PROJECT_FLOP), the six sigma points (the scaled axes 12, the
# points 18), each of the 7 points to pixels (R p + t 18, the divide 2, r^2
# 3, the radial polynomial 6, the factor, focal length and centre 6: 35),
# the weighted mean (28), the deviations (14), the weighted outer products
# (63), the blur, determinant and compensation (13): 423.  The culling
# tests are not counted.
UT_PROJECT_FLOP = 30 + 30 + 7 * 35 + 28 + 14 + 63 + 13
# Per visible gaussian: M = diag(1/s) R^T from the rotation (3 reciprocals,
# 9 multiplies).
WHITEN_FLOP = 12
# The backward per visible gaussian: through M to the scales and the
# quaternion's rotation (WHITEN_FLOP + 30) and through the SH colours.
WHITEN_BWD_FLOP = WHITEN_FLOP + 30


def step_flops(w: dict) -> float:
    """A 3DGUT training step's operations: the UT projection of every
    gaussian, M and SH of the visible ones, the ray composite both ways, the
    colour loss (3 channels) both ways and Adam on the visible rows.  The
    rays are not counted: a camera's rays can be kept from step to step."""
    v, D = w["visible"], w["channels"]
    fwd = (w["gaussians"] * UT_PROJECT_FLOP + v * (WHITEN_FLOP + counts.SH3_FLOP)
           + composite_forward(w["live"], v, w["pixels"], D)[0])
    bwd = (v * (WHITEN_BWD_FLOP + counts.SH3_FLOP) * counts.BACKWARD_FACTOR
           + composite_backward(w["live"], v, w["pixels"], D)[0])
    loss = 2 * w["pixels"] * 3 * counts.LOSS_FLOP_PER_PIXEL_CHANNEL
    adam = v * counts.PARAMS_PER_GAUSSIAN * counts.ADAM_FLOP_PER_PARAM
    return fwd + bwd + loss + adam
