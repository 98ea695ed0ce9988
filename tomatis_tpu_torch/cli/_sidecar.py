"""Params sidecar: `<output>.params.json`, the resolved configuration of a
process run with the gate threshold in the linear gate_scale/gate_offset
form every verifier consumes (a copy of the writer half of
tomatis_tpu/cli/_sidecar.py; the verifiers and their --params loader are
not yet ported).
"""
from __future__ import annotations

import json
import os
import sys


def sidecar_path(output_path) -> str:
    return str(output_path) + ".params.json"


def write_sidecar(output_path, tool: str, resolved: dict) -> str:
    """Write `<output>.params.json`. `resolved` keys that match a
    verifier flag dest are applied by --params; extra keys are kept as
    informational record. Failure to write never fails the run."""
    path = sidecar_path(output_path)
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"tool": tool, **resolved}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
    except OSError as e:
        print(f"warning: params sidecar not written ({e})",
              file=sys.stderr)
    return path


def linear_gate(gate_ui: float, threshold_dbfs: float) -> dict:
    """The linear-form gate triple encoding an already-resolved
    threshold: T = 0 * gate_ui + T for any UI value. Exact for every
    gate_mode, so sidecars are uniform across processors."""
    return {"gate_ui": gate_ui, "gate_scale": 0.0,
            "gate_offset": float(threshold_dbfs),
            "threshold_dbfs": float(threshold_dbfs)}
