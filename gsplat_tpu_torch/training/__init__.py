from .metrics import load_lpips_weights, lpips, lpips_proxy, psnr
from .schedulers import exponential_lr, two_stage_lr

__all__ = ["exponential_lr", "two_stage_lr", "psnr", "lpips", "lpips_proxy",
           "load_lpips_weights"]
