"""Distributed rasterization over a process group (the Grendel scheme).

Port of `gsplat_tpu/parallel/render.py`: gaussian-sharded data parallelism
with a camera-space exchange, as upstream gsplat's distributed mode
(arXiv 2406.18533):

  1. each rank owns `n_l` gaussians; their parameters, optimizer state and
     densification stay on the rank;
  2. each rank renders its own `c_l` cameras;
  3. Seam A: the cameras are all-gathered (`distributed.
     all_gather_tensor_list`), and each rank projects its gaussians into
     every camera;
  4. Seam B: the projected splats go to the rank that owns each camera,
     either dense (one equal-split all-to-all of [W * c_l, n_l, k] rows, then
     the gaussian axis of the W senders concatenated in rank order: the
     JAX `all_to_all(split_axis=0, concat_axis=1)`) or packed (only the
     visible rows, routed by a count matrix, received by
     `rasterize_to_pixels_packed`); tiling and compositing are then local;
  5. backward: each exchange is an autograd Function whose backward is the
     reverse exchange, so `loss.backward()` on every rank gives each rank
     the gradients of its own gaussians.

The JAX function takes global arrays inside one `shard_map`; here the call
is SPMD, one call per rank with the rank's own shard: `means`, `quats`,
`scales`, `opacities`, `colors` [n_l, ...], its cameras' `viewmats`, `Ks`
and `backgrounds` [c_l, ...], `means2d_offset` [C, n_l, 2] (every camera,
this rank's gaussians).  Every rank passes the same n_l and c_l.  It
returns this rank's cameras' renders [c_l, H, W, X]; rank r's cameras are
global cameras r * c_l to (r + 1) * c_l - 1, and its gaussians global rows
r * n_l to (r + 1) * n_l - 1, as the JAX mesh's shards are.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..distributed import all_gather_tensor_list, all_to_all_tensor_list
from ..ops.projection import fully_fused_projection
from ..ops.projection_kernel import sh_colors
from ..ops.rasterize import TILE, rasterize_to_pixels_packed
from ..rendering import (
    DEFAULT_CHUNK,
    _round_up,
    render_mode_has_color,
    render_mode_has_depth_channel,
    render_mode_has_expected_depth,
    render_projected,
)


def _clamped_routes(cnt: torch.Tensor, recv_cap: int) -> torch.Tensor:
    """Per-(sender, destination) admitted row counts (render.py:96-102),
    clipped so that every receive buffer fits recv_cap; every rank computes
    them alike from the all-gathered count matrix cnt[s, d]."""
    col_cum = torch.cumsum(cnt, dim=0) - cnt  # rows before sender s at destination d
    return torch.minimum(torch.clamp(recv_cap - col_cum, min=0), cnt)


class _RaggedExchange(torch.autograd.Function):
    """The count-routed exchange (render.py:51-140): the `send_idx` rows of
    `payload` go out in blocks of `send_sizes` rows, one block to each
    rank; the blocks received (`recv_sizes` rows from each sender, in rank
    order) fill a zero [recv_cap, R] buffer from row 0.  The backward sends
    each received block's gradient back to the rows it came from; rows that
    were not sent (dead, or cut by the clamp) get zero."""

    @staticmethod
    def forward(ctx, payload, send_idx, send_sizes: List[int], recv_sizes: List[int],
                recv_cap: int, group):
        ctx.save_for_backward(send_idx)
        ctx.routes = (send_sizes, recv_sizes, payload.shape[0], group)
        send = payload.index_select(0, send_idx)
        out = payload.new_zeros((recv_cap, payload.shape[1]))
        dist.all_to_all_single(out[: sum(recv_sizes)], send, recv_sizes, send_sizes, group=group)
        return out

    @staticmethod
    def backward(ctx, g_out):
        (send_idx,) = ctx.saved_tensors
        send_sizes, recv_sizes, L, group = ctx.routes
        g_send = g_out.new_empty((sum(send_sizes), g_out.shape[1]))
        dist.all_to_all_single(g_send, g_out[: sum(recv_sizes)].contiguous(), send_sizes,
                               recv_sizes, group=group)
        g_payload = g_out.new_zeros((L, g_out.shape[1])).index_copy_(0, send_idx, g_send)
        return g_payload, None, None, None, None, None


def _packed_exchange(radii, means2d, depths, conics, op_b, feats, W: int, me: int, c_l: int,
                     recv_cap: int, group):
    """Seam B, packed (render.py:293-351): each rank's visible rows sorted
    by destination rank (a stable sort of where(alive, destination, W): the
    JAX (key, row) sort), the [W, W] count matrix all-gathered, the clamped
    routes, then the exchange.  Returns the received rows [recv_cap, R], the
    received count and whether this rank's receive buffer overflowed."""
    I, n_l = radii.shape[:2]
    dev = radii.device
    alive = (radii > 0).all(dim=-1)  # [I, n_l]
    dest = torch.arange(I, device=dev)[:, None] // c_l
    key = torch.where(alive, dest, W).reshape(-1)
    cam_local = (torch.arange(I, device=dev) % c_l)[:, None].expand(I, n_l)
    rows = torch.cat([means2d, conics, op_b[..., None], depths[..., None],
                      radii.to(means2d.dtype), cam_local[..., None].to(means2d.dtype), feats],
                     dim=-1).reshape(I * n_l, -1)
    _, order = torch.sort(key, stable=True)
    payload = rows.index_select(0, order)
    cnt_me = alive.reshape(W, c_l * n_l).sum(dim=1)
    (cnt,) = all_gather_tensor_list([cnt_me[None]], group)  # [W, W]: cnt[s, d]
    allowed = _clamped_routes(cnt, recv_cap)
    cnt_h, allowed_h = torch.stack([cnt, allowed]).tolist()  # the split sizes: one synchronisation
    send_sizes = allowed_h[me]
    recv_sizes = [allowed_h[s][me] for s in range(W)]
    starts = torch.cumsum(cnt[me], dim=0) - cnt[me]  # my rows for each destination
    send_idx = torch.cat([starts[d] + torch.arange(send_sizes[d], device=dev)
                          for d in range(W)])
    recv = _RaggedExchange.apply(payload, send_idx, send_sizes, recv_sizes, recv_cap, group)
    overflow = sum(cnt_h[s][me] for s in range(W)) > recv_cap
    return recv, sum(recv_sizes), overflow


def rasterization_sharded(
    means: torch.Tensor,  # [n_l, 3] this rank's gaussians
    quats: Optional[torch.Tensor],  # [n_l, 4]
    scales: Optional[torch.Tensor],  # [n_l, 3]
    opacities: torch.Tensor,  # [n_l]
    colors: torch.Tensor,  # [n_l, D] or [n_l, K, D] SH
    viewmats: torch.Tensor,  # [c_l, 4, 4] this rank's cameras
    Ks: torch.Tensor,  # [c_l, 3, 3]
    width: int,
    height: int,
    *,
    mesh: DeviceMesh,
    axis: str = "gs",
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    sh_degree: Optional[int] = None,
    tile_size: int = TILE,
    backgrounds: Optional[torch.Tensor] = None,  # [c_l, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    camera_model: str = "pinhole",
    isect_capacity: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,  # [C, n_l, 2] gradient carrier
    absgrad: bool = False,
    packed: bool = False,  # count-routed (ragged) splat exchange
    packed_capacity: Optional[int] = None,  # receive-buffer rows per rank
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Render this rank's cameras from the gaussians of every rank.

    Called on every rank of `mesh`'s dimension `axis` with the rank's own
    shard (module docstring); returns (render_colors [c_l, H, W, X],
    render_alphas [c_l, H, W, 1], meta), the rows of the single-process
    `rasterization()`'s [C, H, W, X] stack that belong to this rank's
    cameras.  Classic 3DGS from quats and scales, per-gaussian colours or SH
    (render.py:154-420).

    `means2d_offset` ([C, n_l, 2], zeros, requires_grad) is the
    densification carrier: after `backward()` its gradient is each camera's
    screen-space mean gradient for this rank's gaussians.  `isect_capacity`
    defaults to 4 c_l N (N = W n_l) rounded up to 128, and `packed_capacity`
    to c_l N.  meta holds this rank's `n_isects` and `isect_overflow` (with
    `packed`, the receive buffer's overflow joins the plan's) beside the
    JAX keys.  `absgrad` is accepted as the JAX function accepts it and,
    as there, reaches no rasterizer (a warning says so).
    """
    group = mesh.get_group(axis)
    W = dist.get_world_size(group)
    me = dist.get_rank(group)
    n_l = means.shape[0]
    c_l = viewmats.shape[0]
    C, N = W * c_l, W * n_l
    if quats is None or scales is None:
        raise ValueError("the sharded path requires quats and scales (no covars), as the "
                         "reference's distributed mode")
    if absgrad:
        warnings.warn("absgrad has no effect on the sharded path: the screen-space gradient "
                      "of means2d_offset is the plain one", stacklevel=2)
    has_color = render_mode_has_color(render_mode)
    has_depth = render_mode_has_depth_channel(render_mode)
    calc_comp = rasterize_mode == "antialiased"

    # backgrounds: None means zeros, an identical blend
    D_color = colors.shape[-1] if has_color else 0
    D_out_global = D_color + (1 if (has_depth or not has_color) else 0)
    if backgrounds is None:
        backgrounds = means.new_zeros((c_l, D_out_global))
    isect_capacity = _round_up(
        max(4 * c_l * N, DEFAULT_CHUNK) if isect_capacity is None else isect_capacity,
        DEFAULT_CHUNK)
    recv_cap = packed_capacity if packed_capacity is not None else c_l * N
    if means2d_offset is None:
        means2d_offset = means.new_zeros((C, n_l, 2))

    # Seam A: every rank's cameras, in rank order
    vm_all, ks_all = all_gather_tensor_list([viewmats, Ks], group)  # [C, 4, 4], [C, 3, 3]
    radii, means2d, depths, conics, comp = fully_fused_projection(
        means, None, quats, scales, vm_all, ks_all, width, height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        calc_compensations=calc_comp, camera_model=camera_model, opacities=opacities,
    )  # [C, n_l, ...]
    op_b = opacities[None].expand(C, n_l)
    if calc_comp:
        op_b = op_b * comp
    if has_color:
        if sh_degree is not None:
            feats = torch.clamp(sh_colors(sh_degree, colors, means, vm_all, radii) + 0.5, min=0.0)
        else:
            feats = colors[None].expand(C, n_l, colors.shape[-1])
        if has_depth:
            feats = torch.cat([feats, depths[..., None]], dim=-1)
    else:
        feats = depths[..., None]
    D_out = feats.shape[-1]
    means2d = means2d + means2d_offset  # the carrier's gradient lands on this rank
    bg = backgrounds
    if bg.shape[-1] < D_out:
        bg = torch.cat([bg, bg.new_zeros((c_l, D_out - bg.shape[-1]))], dim=-1)

    if packed:
        recv, n_recv, ex_overflow = _packed_exchange(
            radii, means2d, depths, conics, op_b, feats, W, me, c_l, recv_cap, group)
        render, alphas, aux = rasterize_to_pixels_packed(
            recv[:, 0:2], recv[:, 2:5], recv[:, 10:], recv[:, 5],
            recv[:, 7:9].to(torch.int32), recv[:, 6], recv[:, 9].to(torch.int32), n_recv, c_l,
            width, height, isect_capacity, backgrounds=bg, tile_size=tile_size,
        )
        overflow = aux["isect_overflow"] | ex_overflow
    else:
        # Seam B, dense: block w of the camera axis goes to rank w; the W
        # senders' gaussian axes are concatenated in rank order
        payload = torch.cat([means2d, conics, op_b[..., None], depths[..., None],
                             radii.to(means2d.dtype), feats], dim=-1)  # [C, n_l, 9 + D_out]
        (recv,) = all_to_all_tensor_list([payload], group)  # [W * c_l, n_l, k], by sender
        recv = recv.reshape(W, c_l, n_l, -1).transpose(0, 1).reshape(c_l, N, -1)
        render, alphas, aux = render_projected(
            recv[..., 0:2], recv[..., 2:5], recv[..., 9:], recv[..., 5],
            recv[..., 7:9].to(torch.int32), recv[..., 6], width, height, tile_size,
            isect_capacity, backgrounds=bg,
        )
        overflow = aux["isect_overflow"]

    if render_mode_has_expected_depth(render_mode):
        d = render[..., -1:] / torch.clamp(alphas, min=1e-10)
        render = torch.cat([render[..., :-1], d], dim=-1)
    meta = {
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "tile_width": -(-width // tile_size),
        "tile_height": -(-height // tile_size),
        "n_cameras": C,
        "n_isects": aux["n_isects"],
        "isect_overflow": overflow,
        "isect_capacity": isect_capacity,
        "mesh_axis": axis,
        "world_size": W,
    }
    return render, alphas, meta
