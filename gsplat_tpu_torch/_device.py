"""Device choice for the port's entry points.

Entry points that create tensors (splats_from_numpy, load_checkpoint)
run on the card unless the caller names another device; with no card and
no device given they raise instead of quietly running on the CPU.
Functions that take tensors follow their inputs' device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device named by the caller, or the card when none is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def check_kernel_device(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when the kernel must launch (CUDA), False for the plain version.

    The plain version runs only because the tensors lie on the CPU; any
    other device, or a mix of devices, raises.
    """
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {dev}")
