"""Grid-vectorized gate simulation for calibration search, PyTorch port of
tomatis_tpu/analysis/gridgate.py.

The reference script runs a quadruple Python loop (gain x delay x hyst x
T), each iteration a sequential per-frame state machine
(ref src/calibrate_to_baseline_v2.py:84-109,241-265). Here ALL grid
combinations are lanes of one loop over the frames: the carry is a
[G]-vector of (state, pending position), each frame a dozen [G]-wide
tensor ops on the device. Frame positions may be non-consecutive (the v2
calibrator simulates over music-masked frames with gaps), which is why
this uses the positional pending rule rather than the frame-count table
scan of ops.gate.

Lanes may carry a leading batch axis: levels [B, F] against thresholds
[B, G] simulate B level tracks (the v2 calibrator's gain-shifted copies)
in the same loop, each row exactly as a call of its own would.
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.utils.device import resolve_device

# sentinel "no pending switch"; positions fit easily in int32
_BIG = int(2 ** 31 - 1)


def grid_gate_scores(levels, starts, tons, toffs, updelay_samples,
                     switch_penalty, target_states, device="cuda"):
    """Simulate the variant-A gate for every grid lane and score it.

    levels [F] (or [B, F]) float32; starts [F] int32 (may have gaps);
    tons/toffs/updelay_samples [G] (or [B, G]); target_states [F] int32
    in {1,2}. Returns numpy (scores, mismatches, switches), each [G] (or
    [B, G]), where score = mismatch_rate + switch_penalty * switches.
    """
    dev = resolve_device(device)
    lv_t = torch.as_tensor(np.asarray(levels, np.float32), device=dev)
    tons = torch.as_tensor(np.asarray(tons, np.float32), device=dev)
    toffs = torch.as_tensor(np.asarray(toffs, np.float32), device=dev)
    ups = torch.as_tensor(np.asarray(updelay_samples, np.int32), device=dev)
    batched = lv_t.ndim == 2
    if batched:
        lv_t = lv_t[:, :, None]                 # [B, F, 1] against [B, G]
    st_list = np.asarray(starts, np.int32).tolist()
    tgt_list = np.asarray(target_states, np.int32).tolist()
    F = len(st_list)

    one = torch.ones((), dtype=torch.int32, device=dev)
    two = torch.full((), 2, dtype=torch.int32, device=dev)
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    state = torch.ones(tons.shape, dtype=torch.int32, device=dev)
    pending = torch.full(tons.shape, _BIG, dtype=torch.int32, device=dev)
    mism = torch.zeros(tons.shape, dtype=torch.int32, device=dev)
    switches = torch.zeros(tons.shape, dtype=torch.int32, device=dev)

    for f in range(F):
        lv = lv_t[:, f] if batched else lv_t[f]
        st = st_list[f]
        a = lv >= tons
        b = lv <= toffs
        in_c1 = state == 1
        arm = in_c1 & a
        new_pending = torch.where(
            arm, torch.where(pending == _BIG, st + ups, pending), big)
        fire = arm & (new_pending <= st)
        next_state = torch.where(in_c1, torch.where(fire, two, one),
                                 torch.where(b, one, two))
        pending = torch.where(fire | ~in_c1, big, new_pending)
        mism += next_state != tgt_list[f]
        if f:
            switches += next_state != state
        state = next_state

    # The reference's mean of the 0/1 mismatches is XLA's: the exact count
    # times the float32 reciprocal of F (not a division). The same
    # arithmetic here, so mismatch rates equal the reference's bit for
    # bit; the score is a separately rounded multiply and add (a compiler
    # that contracts them into one fma differs in the last bit).
    inv_f = float(np.float32(1.0) / np.float32(F))
    mism_rate = mism.to(torch.float32) * inv_f
    scores = mism_rate + switches.to(torch.float32) * float(
        np.float32(switch_penalty))
    return (scores.cpu().numpy(), mism_rate.cpu().numpy(),
            switches.cpu().numpy())


def _lane_arrays(combos, sr: int):
    tons = np.array([c["T"] + c["hyst"] / 2.0 for c in combos], np.float32)
    toffs = np.array([c["T"] - c["hyst"] / 2.0 for c in combos], np.float32)
    ups = np.array([int(round(sr * c["up_ms"] / 1000.0)) for c in combos],
                   np.int32)
    return tons, toffs, ups


def _best_of(combos, scores, mism, sw) -> dict:
    i = int(np.argmin(scores))
    best = dict(combos[i])
    best.update(score=float(scores[i]), mismatch=float(mism[i]),
                switches=int(sw[i]))
    return best


def grid_search(levels: np.ndarray, starts: np.ndarray,
                target_states: np.ndarray, combos, sr: int,
                switch_penalty: float, device="cuda"):
    """Run all (T, hyst, up_ms[, extra...]) combos in one loop; return the
    best combo dict. `combos` is a list of dicts with keys T, hyst, up_ms
    (plus any passthrough keys)."""
    tons, toffs, ups = _lane_arrays(combos, sr)
    scores, mism, sw = grid_gate_scores(
        levels, starts, tons, toffs, ups, switch_penalty, target_states,
        device=device)
    return _best_of(combos, scores, mism, sw)


def grid_search_batched(levels_b, starts: np.ndarray,
                        target_states: np.ndarray, combos_b, sr: int,
                        switch_penalty: float, device="cuda") -> list:
    """grid_search for B level tracks [B, F], each with its own combo
    list, in ONE loop over the frames. Returns the B best combo dicts,
    each what grid_search would return for its row. (A shorter list is
    padded with copies of its last combo: a copy scores as its original
    and comes later, so the first-minimum choice is unchanged.)"""
    G = max(len(c) for c in combos_b)
    lanes = [_lane_arrays(list(c) + [c[-1]] * (G - len(c)), sr)
             for c in combos_b]
    tons, toffs, ups = (np.stack([ln[i] for ln in lanes]) for i in range(3))
    scores, mism, sw = grid_gate_scores(
        np.stack(levels_b), starts, tons, toffs, ups, switch_penalty,
        target_states, device=device)
    return [_best_of(c, scores[i][:len(c)], mism[i], sw[i])
            for i, c in enumerate(combos_b)]
