"""Carry the JAX package's parameters across to the port.

The processors have no weights, but they do have parameters: the
controller's C1/C2 gain table and thresholds, and the processor's
settings. These functions take them as the JAX package hands them out
(numpy arrays, ``dataclasses.asdict``), so both packages compute with the
same numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tomatis_tpu_torch.models.controllers import GateSelectController
from tomatis_tpu_torch.models.standard import StandardParams
from tomatis_tpu_torch.utils.device import resolve_device


def controller_from_reference(table, ton, toff, delay_frames: int,
                              device="cuda") -> GateSelectController:
    """Build the port's controller from the reference controller's
    ``params()`` (table [2, bins], ton, toff as numpy values) and its
    ``delay_frames``."""
    table = np.asarray(table, np.float32)
    if table.ndim != 2 or table.shape[0] != 2:
        raise ValueError(f"expected a [2, bins] gain table, got {table.shape}")
    return GateSelectController(table[0].copy(), table[1].copy(),
                                float(np.float32(ton)),
                                float(np.float32(toff)),
                                int(delay_frames)).to(resolve_device(device))


def standard_params_from_dict(d: dict) -> StandardParams:
    """StandardParams from ``dataclasses.asdict`` of the reference's."""
    names = {f.name for f in dataclasses.fields(StandardParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown StandardParams fields: {sorted(unknown)}")
    return StandardParams(**d)
