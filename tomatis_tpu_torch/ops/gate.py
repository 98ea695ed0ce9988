"""Gate state machines as parallel prefix scans, PyTorch port of
tomatis_tpu/ops/gate.py.

- variant A: hysteresis + up-switch delay with cancel-on-dip. Each frame
  is a transition table over the S = D+2 carry states (s in [0, D] = C1
  with s consecutive frames >= Ton before it, s = D+1 = C2).
- variant B: hysteresis + min-hold frame counter. The carry is
  s = state_idx*(H+1) + h, state_idx 0 = C1 / 1 = C2,
  h = min(frames_since_switch, H), S = 2*(H+1); the initial h is H
  (switching allowed at once).
- the crossfade alpha ramp: x -> min(hi, max(lo, x+b)) is a clip-affine
  map, and such maps are closed under composition.

Composing tables is a gather and composing clip-affine maps is a few
adds, mins and maxes; both are associative. PyTorch has no
associative_scan, so the prefix compositions come from log-step doubling
(Hillis-Steele): ceil(log2 F) steps over [F, S] tables or [F] triples, 10
at the production F = 1024. Integer composition is exact, so gate states
and carries equal the reference's bit for bit; the float ramp composes in
another tree order than jax.lax.associative_scan, so mid-ramp values may
differ in the last bits (saturated values are exactly 0.0 and 1.0: the
clip gives that).
"""
from __future__ import annotations

import numpy as np
import torch

C1, C2 = 1, 2
# finite, so that b1 + a2 never becomes inf - inf
_BIG = 1e9


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


def _select(prefix: torch.Tensor, init_state, default: int):
    """Apply each prefix table [F, S] to the initial carry index."""
    s0 = (torch.full((), default, dtype=torch.int64, device=prefix.device)
          if init_state is None
          else torch.as_tensor(init_state, device=prefix.device).long())
    return torch.gather(prefix, 1, s0.expand(prefix.shape[0], 1))[:, 0]


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
    final = _select(prefix, init_state, 0)
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


def minhold_tables(levels, ton, toff, min_hold_frames: int, valid=None):
    """Per-frame transition tables [F, 2*(H+1)] (int64) of the variant-B
    (min-hold) gate. Invalid frames are identity transitions."""
    H = int(min_hold_frames)
    S = 2 * (H + 1)
    a = levels >= ton
    b = levels <= toff
    s = torch.arange(S, dtype=torch.int64, device=levels.device)
    state_idx = s // (H + 1)       # 0 = C1, 1 = C2
    h1 = torch.clamp(s % (H + 1) + 1, max=H)
    can = h1 >= H
    # next index if the switch condition holds vs not, per entry state
    stay = state_idx * (H + 1) + h1
    flip = (1 - state_idx) * (H + 1)  # switched state with h = 0
    cond_c1 = a[:, None] & (can & (state_idx == 0))[None, :]
    cond_c2 = b[:, None] & (can & (state_idx == 1))[None, :]
    tables = torch.where(cond_c1 | cond_c2, flip[None, :], stay[None, :])
    if valid is not None:
        tables = torch.where(valid[:, None], tables, s[None, :])
    return tables


def minhold_states_from_index(final, min_hold_frames: int):
    """Carry-space index [F] -> gate state in {1, 2}."""
    return torch.where(final >= int(min_hold_frames) + 1, C2,
                       C1).to(torch.int32)


def gate_minhold(levels, ton, toff, min_hold_frames: int, init_state=None,
                 valid=None):
    """Variant-B gate (min-hold) over per-frame levels [F] -> (states [F]
    in {1,2}, carry indices [F]). Exact parallel form of
        frames_since += 1
        if frames_since >= H: allow switch (and reset counter on switch)
    init_state defaults to H: the first frame may switch at once."""
    H = int(min_hold_frames)
    prefix = prefix_compose(minhold_tables(levels, ton, toff, H, valid))
    final = _select(prefix, init_state, H)
    return minhold_states_from_index(final, H), final.to(torch.int32)


def gate_minhold_scan(levels, ton, toff, min_hold_frames: int,
                      init_state=None):
    """Sequential version of gate_minhold (for validation)."""
    H = int(min_hold_frames)
    s = H if init_state is None else int(init_state)
    seq = []
    for level in levels.tolist():
        state_idx = s // (H + 1)
        h1 = min(s % (H + 1) + 1, H)
        flip = h1 >= H and (level >= float(ton) if state_idx == 0
                            else level <= float(toff))
        s = (1 - state_idx) * (H + 1) if flip else state_idx * (H + 1) + h1
        seq.append(s)
    seq = torch.tensor(seq, dtype=torch.int32, device=levels.device)
    return minhold_states_from_index(seq, H), seq


def compose_clip(f, g):
    """Compose clip-affine maps applied f-then-g.

    f = (a1, b1, c1) meaning x -> min(c1, max(b1, x + a1)); likewise g.
    g o f = (a1+a2, max(b2, b1+a2), min(c2, max(b2, c1+a2)))."""
    a1, b1, c1 = f
    a2, b2, c2 = g
    return (a1 + a2,
            torch.maximum(b2, b1 + a2),
            torch.minimum(c2, torch.maximum(b2, c1 + a2)))


def prefix_clip(p):
    """Inclusive prefix compositions of clip-affine maps p = (a, b, c),
    each [F]: out[j] = p_j o ... o p_0, by log-step doubling."""
    d = 1
    while d < p[0].shape[0]:
        comp = compose_clip(tuple(t[:-d] for t in p),
                            tuple(t[d:] for t in p))
        p = tuple(torch.cat([t[:d], u]) for t, u in zip(p, comp))
        d *= 2
    return p


def clip_maps(targets, step, valid=None):
    """The ramp's per-frame clip-affine maps (a, b, c) toward 0/1 targets
    [F]; invalid frames are the identity (0, -_BIG, _BIG)."""
    targets = targets.to(torch.float32)
    dev = targets.device
    step = torch.as_tensor(step, dtype=torch.float32, device=dev)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    zero, one = torch.zeros_like(big), torch.ones_like(big)
    up = targets > 0.5
    a = torch.where(up, step, -step)
    b = torch.where(up, -big, zero)
    c = torch.where(up, one, big)
    if valid is not None:
        a = torch.where(valid, a, zero)
        b = torch.where(valid, b, -big)
        c = torch.where(valid, c, big)
    return a, b, c


def apply_clip(p, x):
    """The clip-affine map(s) p = (a, b, c) applied to x."""
    return torch.minimum(p[2], torch.maximum(p[1], x + p[0]))


def alpha_ramp(targets, step, alpha0, valid=None):
    """Rate-limited crossfade ramp toward per-frame 0/1 targets.

    Exact parallel form of
        diff = target - alpha
        alpha = target            if |diff| <= step
        alpha += step*sign(diff)  otherwise
    which for target=1 is x -> min(1, x+step) and for target=0 is
    x -> max(0, x-step): clip-affine maps, composed by log-step doubling.

    targets: [F] (0.0 or 1.0); step: scalar; alpha0: scalar alpha before
    the first frame's update; valid: optional [F] bool, invalid frames keep
    alpha. Returns alpha [F] float32 after each frame's update."""
    alpha0 = torch.as_tensor(alpha0, dtype=torch.float32,
                             device=targets.device)
    return apply_clip(prefix_clip(clip_maps(targets, step, valid)), alpha0)


def alpha_ramp_snap_first(targets, step):
    """Adaptive-processor variant: alpha[0] = target[0], ramp afterwards."""
    first = targets[:1].to(torch.float32)
    if targets.shape[0] <= 1:
        return first
    return torch.cat([first, alpha_ramp(targets[1:], step, first[0])])


def state_run_stats(states):
    """Run-length / switch statistics used by the adaptive processor.
    Host-side numpy helper."""
    if isinstance(states, torch.Tensor):
        states = states.detach().cpu().numpy()
    states = np.asarray(states)
    if states.size == 0:
        return dict(c2_ratio=0.0, switch_count=0,
                    run_lengths=np.zeros(0, np.int64))
    switches = np.flatnonzero(states[1:] != states[:-1])
    run_ends = np.r_[switches, states.size - 1]
    run_starts = np.r_[0, switches + 1]
    return dict(
        c2_ratio=float(np.mean(states == C2)),
        switch_count=int(len(switches)),
        run_lengths=run_ends - run_starts + 1,
    )
