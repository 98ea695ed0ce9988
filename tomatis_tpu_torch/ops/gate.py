"""Variant-A gate (hysteresis + up-switch delay) as a parallel prefix scan,
PyTorch port of tomatis_tpu/ops/gate.py.

Each frame is a transition table over the S = D+2 carry states (s in
[0, D] = C1 with s consecutive frames >= Ton before it, s = D+1 = C2).
Composing tables is a gather, which is associative. PyTorch has no
associative_scan, so the prefix compositions come from log-step doubling
(Hillis-Steele) with torch.gather: ceil(log2 F) steps of [F, S] gathers,
10 at the production F = 1024. Integer composition is exact, so states
and carries equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

C1, C2 = 1, 2


def updelay_frames(up_delay_samples: int, hop: int) -> int:
    """Smallest d with d*hop >= up_delay_samples."""
    return -(-int(up_delay_samples) // int(hop))


def compose_tables(t_early: torch.Tensor, t_late: torch.Tensor):
    """(t_late o t_early)[s] = t_late[t_early[s]] along the last axis."""
    return torch.gather(t_late, -1, t_early)


def updelay_tables(levels, ton, toff, delay_frames: int, valid=None):
    """Per-frame transition tables [F, S] (int64) of the variant-A gate.
    Invalid frames are identity transitions."""
    D = int(delay_frames)
    S = D + 2
    a = levels >= ton
    b = levels <= toff
    s = torch.arange(S, dtype=torch.int64, device=levels.device)
    c1_next = torch.where(s >= D, D + 1, s + 1)[:D + 1]
    tbl_c1 = torch.where(a[:, None], c1_next[None, :],
                         torch.zeros((), dtype=torch.int64,
                                     device=levels.device))
    tbl_c2 = torch.where(b, 0, D + 1).to(torch.int64)[:, None]
    tables = torch.cat([tbl_c1, tbl_c2], dim=1)
    if valid is not None:
        tables = torch.where(valid[:, None], tables, s[None, :])
    return tables


def prefix_compose(tables: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix compositions: out[j] = t_j o ... o t_0."""
    p = tables
    d = 1
    while d < p.shape[0]:
        p = torch.cat([p[:d], compose_tables(p[:-d], p[d:])], dim=0)
        d *= 2
    return p


def updelay_states_from_index(final, delay_frames: int):
    """Carry-space index [F] -> gate state in {1, 2}."""
    return torch.where(final == delay_frames + 1, C2, C1).to(torch.int32)


def gate_updelay(levels, ton, toff, delay_frames: int, init_state=None,
                 valid=None):
    """Variant-A gate over per-frame levels [F] -> (states [F] in {1,2},
    carry indices [F]); the last index is the carry for the next chunk.

    init_state: int scalar index into the carry space (default 0: C1,
    run count 0). valid: optional [F] bool, invalid frames keep the state.
    """
    D = int(delay_frames)
    prefix = prefix_compose(updelay_tables(levels, ton, toff, D, valid))
    s0 = (torch.zeros((), dtype=torch.int64, device=levels.device)
          if init_state is None
          else torch.as_tensor(init_state, device=levels.device).long())
    final = torch.gather(prefix, 1,
                         s0.expand(prefix.shape[0], 1))[:, 0]
    return (updelay_states_from_index(final, D), final.to(torch.int32))


def gate_updelay_scan(levels, ton, toff, delay_frames: int, init_state=None):
    """Sequential version of gate_updelay (for validation)."""
    D = int(delay_frames)
    s = 0 if init_state is None else int(init_state)
    seq = []
    for level in levels.tolist():
        if s <= D:
            s = (D + 1 if s >= D else s + 1) if level >= float(ton) else 0
        else:
            s = 0 if level <= float(toff) else D + 1
        seq.append(s)
    seq = torch.tensor(seq, dtype=torch.int32, device=levels.device)
    return updelay_states_from_index(seq, D), seq
