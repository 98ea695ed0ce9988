"""The check that decides `correct`: what the timed path produced, held
to the plain reference (benchmark/reference/tomatis_ref.py) run on the
same input samples.

The numbers compared, each against its cell's limit (workloads/<cell>.json
"limits"):
  audio_lsb     the largest gap between an output sample before the
                file's last flush cut and the reference's, in PCM_24
                steps (2^-23 of full scale); an output of another length
                reads inf
  end_lsb       the same over the last flush cut, which holds the file's
                end: its last samples lie under the last frame's window
                tail alone, where y / (wsum + 1e-12) divides by a small
                sum and amplifies float32 rounding (by up to 10^6 where
                the file is a whole number of hops), and the 0.999 peak
                clamp of that cut scales all of it by what it finds there
  state_frames  state-CSV rows whose C1/C2 state is not the reference
                gate's, plus rows missing or extra
  level_db      the largest gap between a row's level and the
                reference's, dB
  alpha_frames  crossfade state-CSV rows whose alpha, as the CSV prints
                it, is not the reference ramp's
Only the numbers a cell's outputs carry are compared. Frames that the
reference marks `masked` (a gate decision within rounding of a threshold
changes their weight) and the samples under them are left out of every
number but level_db."""
from __future__ import annotations

import csv
import math
from dataclasses import dataclass

import numpy as np

from reference import tomatis_ref

FULL_SCALE = 8388608.0


@dataclass
class Answer:
    """One output of the timed path: `pcm` (int32 PCM_24 values, a file's
    samples) or `y` (float samples, an array's), and the parsed state CSV
    where the entry writes one."""
    name: str
    input: int
    pcm: np.ndarray | None = None
    y: np.ndarray | None = None
    csv: dict | None = None


def read_state_csv(path: str) -> dict:
    """The state CSV's columns as the program wrote them."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    out = {"frame_idx": np.array([int(r["frame_idx"]) for r in rows],
                                 np.int64),
           "level": np.array([float(r["level_dbfs"]) for r in rows]),
           "state": np.array([r["state"] for r in rows])}
    if rows and "alpha" in rows[0]:
        out["alpha"] = [r["alpha"] for r in rows]
    return out


def _sample_mask(ref: dict, total: int, n_fft: int) -> np.ndarray:
    """True on the samples under a masked frame."""
    keep = np.ones(total, bool)
    for j in np.nonzero(ref["masked"])[0]:
        s = ref["starts"][j]
        keep[max(0, s):max(0, s + n_fft)] = False
    return keep


def _audio_gaps(a: Answer, ref: dict, n_fft: int) -> dict:
    want = ref["pcm"]
    got = a.pcm if a.pcm is not None else a.y
    if got.shape != want.shape:
        return {"audio_lsb": math.inf, "end_lsb": math.inf}
    if a.pcm is not None:
        gap = np.abs(got.astype(np.int64) - want).max(axis=1)
    else:
        gap = (np.abs(got.astype(np.float64) - ref["y"]).max(axis=1)
               * FULL_SCALE)
    gap = np.where(_sample_mask(ref, len(gap), n_fft), gap, 0)
    cut = ref["last_cut"]
    return {"audio_lsb": float(gap[:cut].max(initial=0)),
            "end_lsb": float(gap[cut:].max(initial=0))}


def _csv_gaps(a: Answer, ref: dict, config: dict) -> dict:
    rows = ref["rows"]
    c = a.csv
    if len(c["frame_idx"]) != len(rows) \
            or not np.array_equal(c["frame_idx"], rows):
        out = {"state_frames": float(max(len(rows), len(c["frame_idx"]))),
               "level_db": math.inf}
        if ref["alpha"] is not None:
            out["alpha_frames"] = math.inf
        return out
    names = np.where(ref["states"][rows] == 2, "C2", "C1")
    held = ~ref["masked"][rows]
    out = {"state_frames": float(np.sum((c["state"] != names) & held)),
           "level_db": float(np.abs(c["level"] - ref["levels"][rows])
                             .max(initial=0))}
    if ref["alpha"] is not None:
        if "alpha" not in c:
            return dict(out, alpha_frames=math.inf)
        fmt = config.get("csv_alpha_format", "%.3f")
        want = [fmt % v for v in ref["alpha"][rows]]
        out["alpha_frames"] = float(sum(g != w and h for g, w, h in
                                        zip(c["alpha"], want, held)))
    return out


def compare(answers: list, inputs, config: dict,
            quantise=tomatis_ref.identity, each: list | None = None) -> dict:
    """{number: worst reading over the answers}. The reference runs once
    per distinct input. `each`, when given, gets (answer name, its
    numbers, the count of masked frames) for every answer."""
    worst: dict = {}
    by_input: dict = {}
    for a in answers:
        by_input.setdefault(a.input, []).append(a)
    for i, group in sorted(by_input.items()):
        ref = tomatis_ref.render(inputs.reference_input(i), config, quantise)
        for a in group:
            nums = _audio_gaps(a, ref, config["params"]["n_fft"])
            if a.csv is not None:
                nums.update(_csv_gaps(a, ref, config))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -math.inf), v)
            if each is not None:
                each.append((a.name, nums, int(ref["masked"].sum())))
        del ref
    return worst


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit; a number without a limit fails."""
    checks, ok = {}, bool(numbers)
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v if math.isfinite(v) else str(v),
                     "limit": lim}
        if lim is None or not v <= lim:
            ok = False
    return ok, checks
