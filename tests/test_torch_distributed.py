"""Port parity: gsplat_tpu_torch.distributed against gsplat_tpu.distributed.

`world_info` and `cli` at world size 1 in this process (gloo on a
HashStore; the group is destroyed after), `cli` as the two ranks of a gloo
world launched the torchrun way and the OpenMPI way (one process each), and
the list collectives at two ranks, forward and backward, against the JAX
helpers on a 2-device mesh.  `run_ranks` (which the parallel tests reuse)
gives each launch an environment of its own and a port that was free a
moment before; nothing leaks into this process's environment.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from gsplat_tpu import distributed as jd
from gsplat_tpu_torch import distributed as td

REPO_ROOT = str(Path(__file__).resolve().parents[1])
LAUNCH_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, world_size: int, port: int, out_dir: Path, kind: str):
    """The environment of one rank: this process's, without any launcher's
    keys, plus the launcher's keys of `kind` (torchrun or openmpi)."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_KEYS}
    env.update(REPO_ROOT=REPO_ROOT, OUT_DIR=str(out_dir), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2")
    if kind == "torchrun":
        env.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    else:
        env.update(OMPI_COMM_WORLD_RANK=str(rank), OMPI_COMM_WORLD_SIZE=str(world_size),
                   OMPI_COMM_WORLD_LOCAL_RANK=str(rank))
    return env


def run_ranks(script: str, out_dir: Path, world_size: int = 2, kind: str = "torchrun",
              timeout: float = 300.0):
    """Run `script` as the ranks of a gloo world, one process each; each rank
    saves OUT_DIR/rank{r}.npz, which this returns in rank order."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "rank_script.py"
    path.write_text(script)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(path)],
                              env=rank_env(r, world_size, port, out_dir, kind),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world_size)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world_size)]


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_world_info_outside_a_group():
    assert td.world_info() == (0, 1, torch.cuda.device_count())


def test_cli_at_world_size_one_runs_identity_collectives(world_of_one):
    got = {}

    def fn(local_rank, world_rank, world_size, args):
        got.update(local_rank=local_rank, world_rank=world_rank, world_size=world_size,
                   args=args, info=td.world_info())
        return "ok"

    assert td.cli(fn, {"x": 1}, device="cpu") == "ok"
    assert got == dict(local_rank=0, world_rank=0, world_size=1, args={"x": 1},
                       info=(0, 1, torch.cuda.device_count()))
    assert dist.get_backend() == "gloo"
    mesh = td.make_gs_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("gs",) and mesh.size() == 1
    a = torch.arange(12, dtype=torch.float32).reshape(4, 3).requires_grad_()
    b = torch.arange(4, dtype=torch.float32)
    ga, gb = td.all_gather_tensor_list([a, b], mesh.get_group("gs"))
    (ea,) = td.all_to_all_tensor_list([a])
    assert torch.equal(ga, a) and torch.equal(gb, b) and torch.equal(ea, a)
    (ga * 2 + ea).sum().backward()
    assert torch.equal(a.grad, torch.full_like(a, 3.0))


def test_cli_refuses_no_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.cli(lambda *a: None)
    assert not dist.is_initialized()


RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO_ROOT"])
from gsplat_tpu_torch import distributed as td

def main(local_rank, world_rank, world_size, args):
    out = dict(ranks=np.array([local_rank, world_rank, world_size]),
               info=np.array(td.world_info()[:2]))
    W, r = world_size, world_rank
    a = torch.arange(W * 2 * 3, dtype=torch.float32).reshape(W * 2, 3)[2 * r:2 * r + 2]
    b = torch.arange(W * 2, dtype=torch.float32)[2 * r:2 * r + 2]
    a.requires_grad_()
    ga, gb = td.all_gather_tensor_list([a, b])
    w = torch.arange(ga.numel(), dtype=torch.float32).reshape(ga.shape) + 1.0
    (ga * w * (r + 1)).sum().backward()
    out.update(ga=ga.detach().numpy(), gb=gb.detach().numpy(), grad_gather=a.grad.numpy())
    c = torch.arange(W * W * 2, dtype=torch.float32).reshape(W * W, 2)[W * r:W * r + W]
    c = (c + 0.0).requires_grad_()
    (e,) = td.all_to_all_tensor_list([c])
    v = torch.arange(e.numel(), dtype=torch.float32).reshape(e.shape) * (r + 1)
    (e * v).sum().backward()
    out.update(a2a=e.detach().numpy(), grad_a2a=c.grad.numpy())
    np.savez(os.path.join(os.environ["OUT_DIR"], f"rank{world_rank}.npz"), **out)

td.cli(main, device="cpu")
"""


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("gs",))


@pytest.mark.parametrize("kind", ["torchrun", "openmpi"])
def test_cli_in_two_processes_and_the_list_collectives(kind, tmp_path, jax_mesh):
    ranks = run_ranks(RANK_SCRIPT, tmp_path / kind, kind=kind)
    W = 2
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["ranks"], [r, r, W])
        np.testing.assert_array_equal(o["info"], [r, W])

    # all_gather_tensor_list against the JAX helper, forward and gradient
    a = jnp.arange(W * 2 * 3, dtype=jnp.float32).reshape(W * 2, 3)
    b = jnp.arange(W * 2, dtype=jnp.float32)
    wgt = jnp.arange(W * 2 * 3, dtype=jnp.float32).reshape(W * 2, 3) + 1.0
    scale = jnp.repeat(jnp.arange(1, W + 1, dtype=jnp.float32), 1)

    def gather_loss(a, b):
        def f(a_l, b_l, s_l):
            ga, gb = jd.all_gather_tensor_list([a_l, b_l], "gs")
            return jnp.sum(ga * wgt * s_l[0])[None], ga, gb

        loss, ga, gb = jax.shard_map(
            f, mesh=jax_mesh, in_specs=(P("gs"), P("gs"), P("gs")),
            out_specs=(P("gs"), P(), P()), check_vma=False)(a, b, scale)
        return jnp.sum(loss), (ga, gb)

    grad, (ga, gb) = jax.grad(gather_loss, has_aux=True)(a, b)
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["ga"], np.asarray(ga))
        np.testing.assert_array_equal(o["gb"], np.asarray(gb))
        np.testing.assert_array_equal(o["grad_gather"], np.asarray(grad)[2 * r:2 * r + 2])

    # all_to_all_tensor_list against the JAX helper, forward and gradient
    c = jnp.arange(W * W * 2, dtype=jnp.float32).reshape(W * W, 2)

    def a2a_loss(c):
        def f(c_l, s_l):
            (e,) = jd.all_to_all_tensor_list([c_l], "gs")
            v = jnp.arange(e.size, dtype=jnp.float32).reshape(e.shape) * s_l[0]
            return jnp.sum(e * v)[None], e

        loss, e = jax.shard_map(f, mesh=jax_mesh, in_specs=(P("gs"), P("gs")),
                                out_specs=(P("gs"), P("gs")), check_vma=False)(c, scale)
        return jnp.sum(loss), e

    grad, e = jax.grad(a2a_loss, has_aux=True)(c)
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["a2a"], np.asarray(e)[W * r:W * r + W])
        np.testing.assert_array_equal(o["grad_a2a"], np.asarray(grad)[W * r:W * r + W])
