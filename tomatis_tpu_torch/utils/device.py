"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to CUDA. A caller that
asks for nothing on a host without a card gets an error, never a quiet
run on the CPU; the CPU is used only when asked for (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
