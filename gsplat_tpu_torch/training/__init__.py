from .schedulers import exponential_lr, two_stage_lr

__all__ = ["exponential_lr", "two_stage_lr"]
