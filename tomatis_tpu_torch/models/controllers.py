"""Gain controllers for the stream engine, PyTorch port of
tomatis_tpu/models/controllers.py (the standard processor's controller).

A controller turns per-frame levels into per-frame linear gain rows and
carries its gate state across chunk boundaries. Its gain table and
thresholds are float32 buffers, so ``.to(device)`` moves them with it.
``params()`` returns the numeric values the step reads; the gate depth
``delay_frames`` stays a plain int, as the reference's static key.
"""
from __future__ import annotations

import torch
from torch import nn

from tomatis_tpu_torch.ops import gate as gate_ops


class GateSelectController(nn.Module):
    """Hysteresis + up-delay gate selecting between two gain curves."""

    LOG_KEYS = ("states",)

    def __init__(self, g1_lin, g2_lin, ton: float, toff: float,
                 delay_frames: int):
        super().__init__()
        self.register_buffer("table", torch.stack([
            torch.as_tensor(g1_lin, dtype=torch.float32),
            torch.as_tensor(g2_lin, dtype=torch.float32)]))
        self.register_buffer("ton", torch.tensor(float(ton),
                                                 dtype=torch.float32))
        self.register_buffer("toff", torch.tensor(float(toff),
                                                  dtype=torch.float32))
        self.delay_frames = int(delay_frames)

    def params(self):
        return (self.table, self.ton, self.toff)

    def init_carry(self):
        return torch.zeros((), dtype=torch.int32, device=self.table.device)

    def step(self, levels, valid, carry, params):
        table, ton, toff = params
        states, seq = gate_ops.gate_updelay(
            levels, ton, toff, self.delay_frames, init_state=carry,
            valid=valid)
        gains = table.index_select(0, (states - 1).long())
        return gains, {"states": states}, seq[-1]
