"""The device an entry point runs on: the CUDA card unless the caller asks
for another. Asking for CUDA where there is no card raises; nothing falls
back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
