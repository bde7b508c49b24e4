"""The check catches the faults each cell can have: the rest of a run,
with the program broken underneath, reads `correct` false (tiny, on the CPU;
the harness's look for a card is skipped by calling the runner).  The
training cell runs the trainer's float32 path here, on which a sound run
reads round-off against the reference (the surfel trainer has no other),
so each fault is all that moves the readings."""

from __future__ import annotations

import pytest
import torch

import gsplat_tpu_torch.scene as scene_pkg
import gsplat_tpu_torch.trainer as trainer_mod
import gsplat_tpu_torch.trainer_2dgs as trainer2d_mod
from benchmark.harness import runner
from benchmark.tests.tiny import tiny_cell

# each training cell and the module whose loss its trainer calls
TRAINING = {"grid5-3dgs.train-4k": trainer_mod, "grid5-2dgs.train-4k": trainer2d_mod}


def _run(workload, exact=False):
    c = tiny_cell(workload, exact=exact)
    return runner.run(c, 2**31 + 99, 0.4, False, torch.device("cpu"), log=lambda m: None)


@pytest.mark.parametrize("workload", TRAINING)
def test_sound_training_run_is_correct(workload):
    assert _run(workload, exact=True)["correct"]


def test_sound_serving_run_is_correct():
    assert _run("grid5-3dgs.serve-4k")["correct"]


def _unchanged(self, params, opt_state, grads, visibility, lr_scale_means):
    return params, opt_state


def _half(loss):
    def on_half_the_rows(pred, target):
        h = pred.shape[-3] // 2
        return loss(pred[..., :h, :, :], target[..., :h, :, :])
    return on_half_the_rows


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_pixels"])
@pytest.mark.parametrize("workload", TRAINING)
def test_training_faults_read_incorrect(monkeypatch, workload, fault):
    mod = TRAINING[workload]
    if fault == "state_unchanged":  # the step computes, Adam never writes
        monkeypatch.setattr(trainer_mod.Trainer, "update", _unchanged)
    else:  # half of the image left out, the mean taken over the rest
        monkeypatch.setattr(mod, "l1_loss", _half(mod.l1_loss))
        monkeypatch.setattr(mod, "ssim_loss", _half(mod.ssim_loss))
    line = _run(workload, exact=True)
    assert not line["correct"], line["checks"]


def test_an_altered_image_reads_incorrect(monkeypatch):
    render = scene_pkg.render_scene

    def altered(*args, **kw):
        img, alpha, meta = render(*args, **kw)
        return img + 2.0 / 255.0, alpha, meta  # two 8-bit levels brighter

    monkeypatch.setattr(scene_pkg, "render_scene", altered)
    line = _run("grid5-3dgs.serve-4k")
    assert not line["correct"], line["checks"]
