"""Gain controllers for the stream engine, PyTorch port of
tomatis_tpu/models/controllers.py.

A controller turns per-frame levels into per-frame linear gain rows and
carries whatever sequential state its gate needs across chunk boundaries
(a tensor, or a tuple of tensors). Its gain curves and thresholds are
float32 buffers, so ``.to(device)`` moves them with it. ``params()``
returns the numeric values the step reads; the gate depth ``delay_frames``
stays a plain int, as the reference's static key.

- GateSelectController    standard processor
- GateXfadeController     crossfade processor
- StaticGainController    EQ appliers
- AlphaGainController     adaptive one-shot pass
"""
from __future__ import annotations

import torch
from torch import nn

from tomatis_tpu_torch.ops import gate as gate_ops
from tomatis_tpu_torch.ops.dsp import db_to_lin


def _f32_buffer(module: nn.Module, name: str, value) -> None:
    module.register_buffer(name, torch.as_tensor(value, dtype=torch.float32))


def _blend_db(alpha, g1_db, g2_db):
    """Per-frame gain rows [F, bins]: the two curves blended in the dB
    domain by alpha [F], then made linear."""
    return db_to_lin((1.0 - alpha)[:, None] * g1_db[None, :]
                     + alpha[:, None] * g2_db[None, :])


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


class GateXfadeController(nn.Module):
    """Gate + rate-limited alpha crossfade, gains blended in the dB domain.
    The carry is (gate index, alpha)."""

    LOG_KEYS = ("states", "alpha")

    def __init__(self, g1_db, g2_db, ton: float, toff: float,
                 delay_frames: int, xfade_frames: int):
        super().__init__()
        _f32_buffer(self, "g1_db", g1_db)
        _f32_buffer(self, "g2_db", g2_db)
        _f32_buffer(self, "ton", float(ton))
        _f32_buffer(self, "toff", float(toff))
        # alpha_step = 1/max(1, xfade_frames); 1.0 is a hard switch
        _f32_buffer(self, "alpha_step", 1.0 / max(1, int(xfade_frames)))
        self.delay_frames = int(delay_frames)

    def params(self):
        return (self.g1_db, self.g2_db, self.ton, self.toff,
                self.alpha_step)

    def init_carry(self):
        dev = self.g1_db.device
        return (torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))

    def step(self, levels, valid, carry, params):
        g1_db, g2_db, ton, toff, alpha_step = params
        gate_carry, alpha0 = carry
        states, seq = gate_ops.gate_updelay(
            levels, ton, toff, self.delay_frames, init_state=gate_carry,
            valid=valid)
        alpha = gate_ops.alpha_ramp((states == 2).to(torch.float32),
                                    alpha_step, alpha0, valid=valid)
        return (_blend_db(alpha, g1_db, g2_db),
                {"states": states, "alpha": alpha}, (seq[-1], alpha[-1]))


class AlphaGainController(nn.Module):
    """Per-frame dB-domain blend driven by a precomputed whole-file alpha
    track (the adaptive processor's one-shot pass). The carry is the
    running frame offset into the alpha track; each chunk takes its
    window."""

    LOG_KEYS = ("alpha",)

    def __init__(self, g1_db, g2_db, alphas):
        super().__init__()
        _f32_buffer(self, "g1_db", g1_db)
        _f32_buffer(self, "g2_db", g2_db)
        _f32_buffer(self, "alphas", alphas)

    def params(self):
        return (self.g1_db, self.g2_db, self.alphas)

    def init_carry(self):
        return torch.zeros((), dtype=torch.int32, device=self.g1_db.device)

    def step(self, levels, valid, carry, params):
        g1_db, g2_db, alphas = params
        F = levels.shape[0]
        # the reference's dynamic_slice clamps the start so that the window
        # stays inside the track (the last, partial chunk); its track is at
        # least F long, and so must this one be
        if alphas.shape[0] < F:
            raise ValueError(f"alpha track of {alphas.shape[0]} frames is "
                             f"shorter than a chunk of {F}")
        # (int() reads the carry back: one small sync a chunk, beside the
        # chunk's own readback)
        start = min(max(int(carry), 0), alphas.shape[0] - F)
        alpha = alphas[start:start + F]
        return _blend_db(alpha, g1_db, g2_db), {"alpha": alpha}, carry + F


class StaticGainController(nn.Module):
    """A single gate-free gain row (EQ appliers)."""

    LOG_KEYS = ()

    def __init__(self, gain_lin):
        super().__init__()
        _f32_buffer(self, "gain", gain_lin)

    def params(self):
        return (self.gain,)

    def init_carry(self):
        return torch.zeros((), dtype=torch.int32, device=self.gain.device)

    def step(self, levels, valid, carry, params):
        (gain,) = params
        return gain[None, :].expand(levels.shape[0], -1), {}, carry
