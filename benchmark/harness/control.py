"""The lower-precision control: the plain reference computed with every
stage rounded to bfloat16 (the nearest precision below the configuration's
float32), put in the program's place. Its outputs take the form the
cell's entry gives: PCM_24 samples and a state CSV, as the program prints
one, for a file mix; float samples for an array mix."""
from __future__ import annotations

import numpy as np

from harness.check import Answer
from reference import tomatis_ref


def answers(inputs, config: dict, quantise=tomatis_ref.bfloat16) -> list:
    out = []
    lvl_fmt = config.get("csv_level_format")
    a_fmt = config.get("csv_alpha_format", "%.3f")
    for i in range(len(inputs)):
        r = tomatis_ref.render(inputs.reference_input(i), config, quantise)
        if inputs.format == "array":
            out.append(Answer(f"control{i}", i, y=r["y"]))
            continue
        rows = r["rows"]
        levels = r["levels"][rows]
        table = {"frame_idx": rows.astype(np.int64),
                 "level": (np.array([float(lvl_fmt % v) for v in levels])
                           if lvl_fmt else levels),
                 "state": np.where(r["states"][rows] == 2, "C2", "C1")}
        if r["alpha"] is not None:
            table["alpha"] = [a_fmt % v for v in r["alpha"][rows]]
        out.append(Answer(f"control{i}", i, pcm=r["pcm"], csv=table))
    return out
