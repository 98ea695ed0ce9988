"""The lower-precision control: the configuration's plain reference
computed with every stage rounded to bfloat16 (the nearest precision
below the configuration's float32), put in the program's place. Its
outputs take the form the cell's entry gives: PCM_24 samples and a state
CSV, as the program prints one, for a file mix; float samples for an
array mix; and, where the cell holds numbers of its own, the further
outputs that their module's outputs() makes at the same precision,
written under the inputs' working directory."""
from __future__ import annotations

import os

import numpy as np

from harness import spec
from harness.check import Answer
from reference import precision


def _state_table(r: dict, config: dict) -> dict:
    """The state CSV of render()'s dict `r`, as the program prints one."""
    lvl_fmt = config.get("csv_level_format")
    a_fmt = config.get("csv_alpha_format", "%.3f")
    rows = r["rows"]
    levels = r["levels"][rows]
    table = {"frame_idx": np.asarray(r["csv_frame_idx"], np.int64),
             "level": (np.array([float(lvl_fmt % v) for v in levels])
                       if lvl_fmt else levels),
             "state": np.where(r["states"][rows] == 2, "C2", "C1")}
    if r["alpha"] is not None:
        table["alpha"] = [a_fmt % v for v in r["alpha"][rows]]
    return table


def answers(inputs, config: dict, quantise=precision.bfloat16,
            own=None) -> list:
    """One answer per input; `own` is the module of the cell's own numbers
    (spec.own_numbers), or None."""
    reference = spec.reference(config)
    out = []
    for i in range(len(inputs)):
        x = inputs.reference_input(i)
        r = reference.render(x, config, quantise)
        if inputs.format == "array":
            a = Answer(f"control{i}", i, y=r["y"])
        else:
            a = Answer(f"control{i}", i, pcm=r["pcm"],
                       csv=_state_table(r, config))
        if own is not None:
            d = os.path.join(inputs.workdir, f"control{i}")
            os.makedirs(d, exist_ok=True)
            a.files = own.outputs(a, x, r, config, quantise, d)
        out.append(a)
    return out
