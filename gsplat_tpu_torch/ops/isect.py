"""Tile intersection, depth sort and the chunk-aligned per-tile worklist.

Port of `gsplat_tpu/ops/isect.py:34-247` (Isects, TileWorklist,
isect_tiles, isect_offset_encode, build_tile_worklist), equal to it bit for
bit on both devices.

`isect_tiles` emits through K8 (`gather_kernel.expand_emission_aabb`, the
AABB emission of the 2DGS path) on a CUDA tensor and through K8's plain
version on the CPU.  K8 takes any run lengths: here each gaussian owns
exactly its covered tiles (a culled one none, where the 2DGS plan gives it
a dummy slot), so the slots, the `capacity` cut in emission order and the
tail past `n_isects` (sentinel key, +inf, id 0) are the JAX function's.
The JAX sort is a stable two-key sort on (tile key, float depth); here it
is one stable sort of the int64 key tile << 32 | the depth's order bits,
where the bits map floats to unsigned integers in float order with -0.0
taken as +0.0, as XLA's sort compares them, so negative depths sort as
there too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gather_kernel import expand_emission_aabb


class Isects(NamedTuple):
    """Sorted intersection list (fixed capacity)."""

    tiles_per_gauss: torch.Tensor  # [I, N] int32
    tile_keys: torch.Tensor  # [P] int32, sorted; I*n_tiles marks padding
    depth_keys: torch.Tensor  # [P] float32, sorted within each tile
    flatten_ids: torch.Tensor  # [P] int32 into [I*N]; 0 for padding
    n_isects: torch.Tensor  # [] int32 true count (<= capacity if no overflow)
    overflow: torch.Tensor  # [] bool, True if capacity was exceeded


class TileWorklist(NamedTuple):
    """Chunk-aligned per-tile layout of the sorted intersection list.

    Aligned slot `a` maps to sorted entry `src_idx[a]` when `valid[a]`, else
    it is padding.  Tile `t`'s chunks start at chunk index `chunk_starts[t]`
    and span `n_chunks[t]` chunks.
    """

    src_idx: torch.Tensor  # [A] int32 into the sorted arrays
    valid: torch.Tensor  # [A] bool
    chunk_starts: torch.Tensor  # [T] int32 (in units of chunks)
    n_chunks: torch.Tensor  # [T] int32
    tile_starts: torch.Tensor  # [T] int32 range starts in the *sorted* list
    tile_counts: torch.Tensor  # [T] int32 range lengths in the sorted list


def _fill_forward_index(boundary_pos: torch.Tensor, live: torch.Tensor, capacity: int) -> torch.Tensor:
    """Map each slot j in [0, capacity) to the run covering it: run ids
    scattered at their start positions by max, then a cumulative max."""
    E = boundary_pos.shape[0]
    pos = torch.clamp(torch.where(live, boundary_pos.long(), capacity), max=capacity)
    mark = torch.full((capacity + 1,), -1, dtype=torch.int32, device=boundary_pos.device)
    mark = mark.scatter_reduce(0, pos, torch.arange(E, dtype=torch.int32, device=pos.device),
                               reduce="amax")
    return torch.clamp(torch.cummax(mark[:capacity], dim=0).values, min=0)


def _depth_order_bits(depth: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) in the order XLA's sort gives floats
    (-0.0 equal to +0.0; NaN after +inf)."""
    d = torch.where(depth == 0.0, 0.0, depth)
    d = torch.where(torch.isnan(d), float("nan"), d)
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits | 0x80000000)


def isect_tiles(
    means2d: torch.Tensor,  # [I, N, 2]
    radii: torch.Tensor,  # [I, N, 2] int32
    depths: torch.Tensor,  # [I, N]
    tile_size: int,
    tile_width: int,
    tile_height: int,
    capacity: int,
    sort: bool = True,
) -> Isects:
    """Enumerate (image, tile, gaussian) intersections, sorted by (tile, depth).

    A live gaussian (both radii > 0) covers the tiles [floor(mean/ts -
    r/ts), ceil(mean/ts + r/ts)) clamped to the grid, row by row; slots past
    `n_isects` hold (I * tiles, +inf, 0); `overflow` says `capacity` cut
    the list (in emission order).  Equal keys keep emission order.
    """
    I, N = means2d.shape[0], means2d.shape[1]
    E = I * N
    n_tiles = tile_width * tile_height
    sentinel = I * n_tiles
    dev = means2d.device

    m2 = means2d.detach().reshape(E, 2)
    rad = radii.reshape(E, 2)
    tmean = m2 / tile_size
    trad = rad.to(m2.dtype) / tile_size
    tmin = torch.floor(tmean - trad).to(torch.int32)
    tmax = torch.ceil(tmean + trad).to(torch.int32)
    tmin_x = torch.clamp(tmin[:, 0], 0, tile_width)
    tmin_y = torch.clamp(tmin[:, 1], 0, tile_height)
    w = torch.clamp(tmax[:, 0], 0, tile_width) - tmin_x
    h = torch.clamp(tmax[:, 1], 0, tile_height) - tmin_y
    alive = (rad > 0).all(dim=-1)
    cnt = torch.where(alive, w * h, 0).to(torch.int32)
    cum_in = torch.cumsum(cnt, dim=0, dtype=torch.int32)
    n_isects = cum_in[-1] if E else torch.zeros((), dtype=torch.int32, device=dev)

    rect = torch.stack([tmin_x, tmin_y, torch.clamp(w, min=1),
                        torch.arange(E, dtype=torch.int32, device=dev) // N]).to(torch.int32)
    n_slots = torch.clamp(n_isects, max=capacity).reshape(1).to(torch.int32)
    keys, depth_keys, flat, _ = expand_emission_aabb(
        cum_in, rect.contiguous(), depths.detach().reshape(E).to(torch.float32).contiguous(),
        None, n_slots, capacity, tile_width, n_tiles, sentinel,
    )
    if sort:
        _, order = torch.sort((keys.to(torch.int64) << 32) | _depth_order_bits(depth_keys),
                              stable=True)
        keys, depth_keys, flat = keys[order], depth_keys[order], flat[order]
    return Isects(
        tiles_per_gauss=cnt.reshape(I, N),
        tile_keys=keys,
        depth_keys=depth_keys,
        flatten_ids=flat,
        n_isects=n_isects.to(torch.int32),
        overflow=n_isects > capacity,
    )


def isect_offset_encode(
    tile_keys: torch.Tensor,  # [P] sorted
    I: int,
    tile_width: int,
    tile_height: int,
) -> torch.Tensor:
    """Per-(image, tile) start offsets [I, tile_height, tile_width] int32."""
    dense = torch.arange(I * tile_width * tile_height, dtype=tile_keys.dtype,
                         device=tile_keys.device)
    offsets = torch.searchsorted(tile_keys, dense, side="left", out_int32=True)
    return offsets.reshape(I, tile_height, tile_width)


def build_tile_worklist(
    tile_keys: torch.Tensor,  # [P] sorted (with sentinel padding)
    n_tiles_total: int,
    chunk: int,
) -> TileWorklist:
    """Chunk-aligned per-tile ranges over the sorted intersection list.

    The aligned capacity is P + n_tiles_total * chunk: each tile's range is
    padded up to a multiple of `chunk`, so no chunk holds two tiles.
    """
    P = tile_keys.shape[0]
    T = n_tiles_total
    A = _aligned_capacity(P, T, chunk)
    AC = -(-A // chunk)
    dev = tile_keys.device

    probes = torch.arange(T + 1, dtype=tile_keys.dtype, device=dev)
    bounds = torch.searchsorted(tile_keys, probes, side="left", out_int32=True)
    tile_starts = bounds[:-1]
    tile_counts = bounds[1:] - bounds[:-1]
    n_chunks = torch.div(tile_counts + chunk - 1, chunk, rounding_mode="floor")
    chunk_starts = torch.cumsum(n_chunks, dim=0, dtype=torch.int32) - n_chunks

    t = _fill_forward_index(chunk_starts, n_chunks > 0, AC).long()  # [AC] -> tile
    a_start = (chunk_starts * chunk)[t][:, None]
    t_start = tile_starts[t][:, None]
    t_count = tile_counts[t][:, None]
    a = (torch.arange(AC, dtype=torch.int32, device=dev)[:, None] * chunk
         + torch.arange(chunk, dtype=torch.int32, device=dev)[None, :])
    within = a - a_start
    valid = within < t_count
    src = torch.where(valid, t_start + within, 0).to(torch.int32)
    return TileWorklist(
        src_idx=src.reshape(AC * chunk)[:A],
        valid=valid.reshape(AC * chunk)[:A],
        chunk_starts=chunk_starts.to(torch.int32),
        n_chunks=n_chunks.to(torch.int32),
        tile_starts=tile_starts,
        tile_counts=tile_counts,
    )


def _aligned_capacity(P: int, n_tiles_total: int, chunk: int) -> int:
    """Static aligned-buffer capacity for `build_tile_worklist`."""
    return P + n_tiles_total * chunk
