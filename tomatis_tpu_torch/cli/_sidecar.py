"""Params sidecar: `<output>.params.json`, the resolved configuration of a
process run with the gate threshold in the linear gate_scale/gate_offset
form every verifier consumes, and the verifiers' --params loader (a copy
of tomatis_tpu/cli/_sidecar.py).

The verifier CLIs keep the reference's per-tool defaults, which differ
from the processors' (validate: hyst 1.0, up_delay 0, gate_offset -61.08,
±5 dB tilt; the processor: hyst 3.0, up_delay 250, ±15 dB). Precedence:
tool defaults < sidecar < explicitly typed flags. The loader never takes
`device` from a sidecar: the port's --device keeps its default or the
typed value.
"""
from __future__ import annotations

import argparse
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


def add_params_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--params", default="auto",
                    help="params sidecar (<out>.params.json, written by "
                         "the process* commands): fills every flag you "
                         "did not type explicitly; typed flags win. "
                         "'auto' (default) loads the sidecar next to -o "
                         "when one exists; 'none' disables")


def apply_params(args: argparse.Namespace, build_parser, argv) -> None:
    """Overlay the --params sidecar onto `args` in place.

    Only dests the parser knows AND the user did not explicitly type are
    overwritten, so reference-quirk defaults stay intact without a
    sidecar and any typed flag beats the sidecar.
    """
    p = getattr(args, "params", None)
    if p in (None, "none", ""):
        return
    if p == "auto":
        p = sidecar_path(args.output)
        if not os.path.isfile(p):
            return
    with open(p, "r", encoding="utf-8") as f:
        side = json.load(f)
    args.params = p
    # which dests did the user actually type? Re-parse argv with every
    # default suppressed: only provided options materialize.
    probe = build_parser()
    for act in probe._actions:
        act.default = argparse.SUPPRESS
        act.required = False
    typed, _ = probe.parse_known_args(
        list(sys.argv[1:]) if argv is None else list(argv))
    typed_dests = set(vars(typed))
    known = {a.dest for a in build_parser()._actions}
    applied = []
    for key, val in side.items():
        if key in known and key not in typed_dests and hasattr(args, key) \
                and key != "device":
            setattr(args, key, val)
            applied.append(key)
    if applied:
        print(f"params loaded from {os.path.basename(args.params)}: "
              + ", ".join(sorted(applied)))
