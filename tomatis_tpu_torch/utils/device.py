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


def resolve_devices(n: int | None = None, device="cuda") -> list:
    """The device list of a mesh or of a batch's lane blocks. `device`
    "cuda" (no index): the first n CUDA devices, all of them when n is
    None; one named device (cuda:N, cpu): that device n times (once when
    n is None), so that several shards or lane blocks share it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        k = min(n, count) if n else count
        return [torch.device("cuda", i) for i in range(k)]
    return [dev] * (n or 1)
