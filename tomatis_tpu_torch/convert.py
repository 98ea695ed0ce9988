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

from tomatis_tpu_torch.models.controllers import (GateSelectController,
                                                  GateXfadeController)
from tomatis_tpu_torch.models.standard import StandardParams
from tomatis_tpu_torch.models.xfade import XfadeParams
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


def xfade_controller_from_reference(g1_db, g2_db, ton, toff, alpha_step,
                                    delay_frames: int,
                                    device="cuda") -> GateXfadeController:
    """Build the port's crossfade controller from the reference
    controller's ``params()`` (the two dB curves [bins], ton, toff and
    alpha_step as numpy values) and its ``delay_frames``."""
    g1_db, g2_db = np.asarray(g1_db, np.float32), np.asarray(g2_db, np.float32)
    if g1_db.ndim != 1 or g1_db.shape != g2_db.shape:
        raise ValueError(f"expected two [bins] dB curves, got "
                         f"{g1_db.shape} and {g2_db.shape}")
    ctl = GateXfadeController(g1_db.copy(), g2_db.copy(),
                              float(np.float32(ton)), float(np.float32(toff)),
                              int(delay_frames), 1)
    # the step itself, not a frame count: 1/n in float32 stays the
    # reference's value bit for bit
    ctl.alpha_step.fill_(float(np.float32(alpha_step)))
    return ctl.to(resolve_device(device))


def _params_from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**d)


def standard_params_from_dict(d: dict) -> StandardParams:
    """StandardParams from ``dataclasses.asdict`` of the reference's."""
    return _params_from_dict(StandardParams, d)


def xfade_params_from_dict(d: dict) -> XfadeParams:
    """XfadeParams from ``dataclasses.asdict`` of the reference's."""
    return _params_from_dict(XfadeParams, d)


def adaptive_params_from_dict(d: dict):
    """AdaptiveParams from ``dataclasses.asdict`` of the reference's."""
    from tomatis_tpu_torch.models.adaptive import AdaptiveParams
    return _params_from_dict(AdaptiveParams, d)


def eq_gain_bins_from_reference(gain_bins, n_fft: int) -> np.ndarray:
    """The EQ appliers' per-bin linear gains as the reference builds them
    (``build_gain_per_bin``, ``build_eq_from_residual*``): float32
    [n_fft//2 + 1], handed to ``models.eq.apply_gain_stream`` as they
    are. The checkpoint fingerprint hashes these bytes, so a checkpoint
    written by either package names the same curve."""
    g = np.ascontiguousarray(gain_bins, np.float32)
    if g.shape != (n_fft // 2 + 1,):
        raise ValueError(f"expected [{n_fft // 2 + 1}] gain bins, "
                         f"got {g.shape}")
    return g
