"""Process-group bootstrap and collective helpers on torch.distributed.

Port of `gsplat_tpu/distributed.py`.  The JAX package runs SPMD inside one
`shard_map` over a device mesh; here each rank is a process, as in upstream
gsplat:

  * `cli(fn, args, device)`: initialise the default process group from the
    environment (torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT, or OpenMPI's OMPI_COMM_WORLD_* with MASTER_ADDR /
    MASTER_PORT, as gsplat_tpu/distributed.py:58-63), NCCL on the card and
    gloo with `device="cpu"`, then call `fn(local_rank, world_rank,
    world_size, args)` once in this process.  With no such environment it
    makes a world of one rank (a HashStore), so that the collectives below
    run as identity collectives, as the JAX ones do on one device.
  * `world_info()`: (world rank, world size, CUDA devices on this host).
  * `make_gs_mesh(axis)`: a one-dimensional `DeviceMesh` over the world,
    PyTorch's counterpart of the JAX 1-D `Mesh`.
  * `all_gather_tensor_list` and `all_to_all_tensor_list`: a list of
    tensors in ONE collective (flatten, concatenate, split), as
    gsplat_tpu/distributed.py:96-138.  `torch.distributed`'s collectives
    are not differentiable, so each is an autograd Function whose backward
    is the reverse collective (reduce-scatter; the same all-to-all), as
    `jax.grad` transposes the JAX ones.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ._device import DeviceLike, resolve_device


def world_info() -> Tuple[int, int, int]:
    """(world_rank, world_size, local CUDA device count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), torch.cuda.device_count()
    return 0, 1, torch.cuda.device_count()


def _environment_ranks() -> Optional[Tuple[int, int, int, str]]:
    """(local rank, world rank, world size, tcp address) from torchrun's or
    OpenMPI's environment, or None for a single-process launch."""
    env = os.environ
    addr = env.get("MASTER_ADDR", "127.0.0.1")
    port = env.get("MASTER_PORT", "8476")
    if "RANK" in env and "WORLD_SIZE" in env:
        ranks = (int(env.get("LOCAL_RANK", "0")), int(env["RANK"]), int(env["WORLD_SIZE"]))
    elif "OMPI_COMM_WORLD_SIZE" in env:
        ranks = (int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")),
                 int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"]))
    else:
        return None
    return (*ranks, f"tcp://{addr}:{port}")


def cli(fn: Callable, args: Any = None, device: DeviceLike = None) -> Any:
    """Run `fn(local_rank, world_rank, world_size, args)` in this process.

    Initialises the default process group unless one exists: from the
    environment (one process per rank), else a world of one rank.  The
    backend is NCCL on the card (the rank's device is cuda:local_rank) and
    gloo with `device="cpu"`.  The group stays up for the caller;
    `torch.distributed.destroy_process_group()` ends it.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    ranks = _environment_ranks()
    local_rank = ranks[0] if ranks is not None else 0
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        if ranks is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=ranks[3], rank=ranks[1],
                                    world_size=ranks[2])
    return fn(local_rank, dist.get_rank(), dist.get_world_size(), args)


def make_gs_mesh(axis: str = "gs", device: DeviceLike = None) -> DeviceMesh:
    """A 1-D DeviceMesh over every rank of the world, its dimension named
    `axis` (the gaussian-shard axis); on the card unless `device` says."""
    dev = resolve_device(device)
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(t.shape[0], -1) for t in tensors], dim=1).contiguous()


def _split(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    pieces = torch.split(flat, [math.prod(t.shape[1:]) for t in tensors], dim=1)
    return [p.reshape((flat.shape[0],) + t.shape[1:]) for p, t in zip(pieces, tensors)]


class _AllGather(torch.autograd.Function):
    """[n, F] on every rank -> [W * n, F] in rank order; backward: the
    reduce-scatter of the gradient (each rank's block, summed over ranks)."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        out = flat.new_empty((dist.get_world_size(group) * flat.shape[0], flat.shape[1]))
        dist.all_gather_into_tensor(out, flat, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        W = dist.get_world_size(ctx.group)
        out = grad.new_empty((grad.shape[0] // W, grad.shape[1]))
        dist.reduce_scatter_tensor(out, grad.contiguous(), group=ctx.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    """[W * n, F]: block i goes to rank i; the received blocks stack in rank
    order.  An equal-split all-to-all is its own inverse, so the backward is
    the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def all_gather_tensor_list(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """All-gather a list of tensors in ONE collective: each comes back with
    the ranks' leading blocks stacked ([W * n, ...]).  Differentiable."""
    return _split(_AllGather.apply(_flat(tensors), group), tensors)


def all_to_all_tensor_list(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """All-to-all a list of tensors in ONE collective along the leading
    dimension, which the world size must divide: block i of each goes to
    rank i.  Differentiable."""
    W = dist.get_world_size(group)
    for t in tensors:
        if t.shape[0] % W:
            raise ValueError(f"leading dimension {t.shape[0]} is not divisible by the world "
                             f"size {W}")
    return _split(_AllToAll.apply(_flat(tensors), group), tensors)
