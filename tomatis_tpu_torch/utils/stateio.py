"""State-CSV schemas — a compatibility surface of the framework.

Three schema variants exist in the reference and are consumed downstream by
validate_layer1 (src/validate_layer1.py:95-107) and merge_state_volume
(src/merge_state_volume.py:40-43):

- standard:  frame_idx,time_sec,level_dbfs,state        (src/process_tomatis.py:305)
- crossfade: frame_idx,time_sec,level_dbfs,state,alpha  (src/process_tomatis_xfade.py:180)
- adaptive:  frame_idx,time_sec,level_dbfs,state,alpha  (src/process_tomatis_adaptive.py:358)

frame_idx counts *all* processed frames including the pad-region ones, but
rows are only written for frames whose start lies in [0, total) — so the
first logged frame_idx is pad//hop (src/process_tomatis.py:407-409).
"""
from __future__ import annotations

import csv

STATE_NAMES = {1: "C1", 2: "C2"}


class StateCsvWriter:
    """Streaming writer for the per-frame state audit trail."""

    def __init__(self, path, sr: int, total: int, with_alpha: bool = False,
                 level_fmt=None, alpha_fmt=None):
        """level_fmt/alpha_fmt: printf formats. The standard processor
        writes raw floats; the crossfade processor writes level %.2f and
        alpha %.3f (src/process_tomatis_xfade.py:293-295)."""
        self.sr = sr
        self.total = total
        self.with_alpha = with_alpha
        self.level_fmt = level_fmt
        self.alpha_fmt = alpha_fmt
        header = ["frame_idx", "time_sec", "level_dbfs", "state"]
        if with_alpha:
            header.append("alpha")
        self._f = open(path, "w", newline="", encoding="utf-8")
        self._w = csv.writer(self._f)
        self._w.writerow(header)

    def on_frames(self, frame0: int, starts, log):
        levels = log["levels"]
        states = log.get("states")
        alphas = log.get("alpha")
        for i, start in enumerate(starts):
            if not (0 <= start < self.total):
                continue
            level = float(levels[i])
            row = [frame0 + i, start / self.sr,
                   self.level_fmt % level if self.level_fmt else level,
                   STATE_NAMES.get(int(states[i]), "?") if states is not None
                   else ""]
            if self.with_alpha:
                a = float(alphas[i]) if alphas is not None else 0.0
                row.append(self.alpha_fmt % a if self.alpha_fmt else a)
            self._w.writerow(row)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_state_csv(path):
    """Read any state-CSV variant into dict-of-lists (host side)."""
    import numpy as np
    with open(path, newline="", encoding="utf-8") as f:
        rdr = csv.DictReader(f)
        rows = list(rdr)
    out = {
        "frame_idx": np.array([int(r["frame_idx"]) for r in rows], np.int64),
        "time_sec": np.array([float(r["time_sec"]) for r in rows]),
        "level_dbfs": np.array([float(r["level_dbfs"]) for r in rows]),
        "state": np.array([r["state"] for r in rows]),
    }
    if rows and "alpha" in rows[0]:
        out["alpha"] = np.array([float(r["alpha"]) for r in rows])
    return out
