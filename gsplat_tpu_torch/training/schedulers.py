"""Learning-rate schedules used by the trainer.

Port of `gsplat_tpu/training/schedulers.py`.  Steps are Python numbers on
the host, so these return floats.
"""

from __future__ import annotations


def exponential_lr(step: float, base_lr: float, max_steps: int, final_ratio: float = 0.01) -> float:
    """base_lr * final_ratio^(step / max_steps)."""
    return base_lr * final_ratio ** (step / max_steps)


def two_stage_lr(step: float, base_lr: float, stage1_steps: int, stage2_lr: float) -> float:
    """Constant base_lr through stage 1, then stage2_lr."""
    return base_lr if step < stage1_steps else stage2_lr
