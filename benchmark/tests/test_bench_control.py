"""The control: the reference put in the program's place, one precision
below the configuration's (float8 payload and per-slot gradients for the
bf16-pair 3DGS paths, bfloat16 for the float32 surfel path).  On the card,
at each cell's own size, it reads `correct` false against the cell's
limits; on the CPU, at a tiny size, it reads well above a sound run."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import runner
from benchmark.tests.tiny import tiny_cell

CELLS = [w["name"] for w in json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _readings(c, seed, device, seconds):
    sess = c.model.open_session(c.config, c.traffic, c.check, seed, device)
    if c.traffic["kind"] != "train":
        runner.WINDOWS[c.traffic["kind"]](sess, seconds, device)
    sess.close()
    return sess.readings(), sess.control()


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_a_sound_run_on_the_cpu(workload):
    c = tiny_cell(workload, exact=True)
    sound, control = _readings(c, 2**31 + 5, torch.device("cpu"), 0.3)
    assert all(control[k] >= 3 * sound[k] for k in sound), (sound, control)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cells_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cell_mod.resolve(workload)
    _, control = _readings(c, 2**31 + 5, torch.device("cuda"), 5.0)
    assert any(control[k] > c.limits[k] for k in c.limits), control
