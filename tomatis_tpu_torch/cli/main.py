"""CLI dispatcher of the PyTorch port:
`python -m tomatis_tpu_torch.cli.main <command> ...`.

The three processors, the batch processor, the EQ appliers, the repair
tools, the device-matching workflow with its analysis commands, the
verifiers, the level and segment analyzers and doctor are ported: 29 of
the 35 commands of tomatis_tpu/cli/main.py. The six still queued in
ROADMAP.md are compare-baseline, compare-three, compare-diff-spectrum,
plot-diff, reverse-engineer and process-sharded.

An entry is (module, help) and the module's main() runs, or (module,
help, function) and that function runs, as in the reference's table.
"""
from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "process": ("tomatis_tpu_torch.cli.process",
                "standard gate-controlled C1/C2 tilt processor"),
    "process-xfade": ("tomatis_tpu_torch.cli.process_xfade",
                      "processor with crossfade state transitions"),
    "process-batch": ("tomatis_tpu_torch.cli.process_batch",
                      "process many files per device step (file lanes)"),
    "process-adaptive": ("tomatis_tpu_torch.cli.process_adaptive",
                         "adaptive processor (auto threshold, min-hold, "
                         "crossfade)"),
    "apply-eq": ("tomatis_tpu_torch.cli.apply_eq",
                 "apply a static EQ curve (layer 2)"),
    "apply-residual-eq": ("tomatis_tpu_torch.cli.apply_residual_eq",
                          "apply a clamped residual EQ (layer 2b; --safe "
                          "for Safe-B)"),
    "declick": ("tomatis_tpu_torch.cli.repair",
                "detect and inpaint clicks/pops"),
    "cut": ("tomatis_tpu_torch.cli.cut", "trim the first N seconds"),
    "compare": ("tomatis_tpu_torch.cli.compare",
                "pairwise comparator -> diff_spectrum.csv"),
    "analyze-eq": ("tomatis_tpu_torch.cli.analyze_eq",
                   "derive the layer-2 EQ curve"),
    "calibrate": ("tomatis_tpu_torch.cli.calibrate",
                  "fit gate params to a device recording (v1)"),
    "calibrate-v2": ("tomatis_tpu_torch.cli.calibrate_v2",
                     "fit gate params + gain (v2)"),
    "match": ("tomatis_tpu_torch.cli.match",
              "one-command device matching: calibrate -> process -> EQ -> "
              "residual EQ"),
    "convert": ("tomatis_tpu_torch.cli.convert",
                "convert audio between WAV and FLAC"),
    "validate": ("tomatis_tpu_torch.cli.validate",
                 "layer-1 validation (gate recomputation, filter shape, "
                 "engineering)"),
    "verify-15db": ("tomatis_tpu_torch.cli.verify_15db",
                    "full +-15 dB verification suite"),
    "verify-15db-v2": ("tomatis_tpu_torch.cli.verify_15db_v2",
                       "adaptive-mode verification (auto threshold)"),
    "verify-tilt": ("tomatis_tpu_torch.cli.verify_tilt",
                    "measure realized tilt amplitude by level grouping"),
    "doctor": ("tomatis_tpu_torch.cli.doctor",
               "verify the runtime environment end to end"),
    "analyze-dbfs": ("tomatis_tpu_torch.cli.analyzers",
                     "RMS dBFS distribution / gate_ui suggestions",
                     "dbfs_main"),
    "analyze-gate-threshold": ("tomatis_tpu_torch.cli.analyzers",
                               "estimate device gate threshold from "
                               "dBFS CSVs", "gate_threshold_main"),
    "analyze-stereo": ("tomatis_tpu_torch.cli.analyzers",
                       "per-channel threshold + min-hold gate CSV",
                       "stereo_main"),
    "compare-dbfs": ("tomatis_tpu_torch.cli.analyzers",
                     "align recordings and emit frame-dBFS track CSVs",
                     "compare_dbfs_main"),
    "merge-state-volume": ("tomatis_tpu_torch.cli.analyzers",
                           "join state CSV with per-channel dBFS",
                           "merge_main"),
    "inspect": ("tomatis_tpu_torch.cli.analyzers",
                "amplitude profile with ASCII bars + plot", "inspect_main"),
    "inspect-transition": ("tomatis_tpu_torch.cli.analyzers",
                           "100ms dBFS table of a window",
                           "transition_main"),
    "find-segment": ("tomatis_tpu_torch.cli.analyzers",
                     "find the main music segment", "find_segment_main"),
    "find-start": ("tomatis_tpu_torch.cli.analyzers",
                   "smart music-start detection", "find_start_main"),
    "find-end": ("tomatis_tpu_torch.cli.analyzers",
                 "smart music-end detection", "find_end_main"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m tomatis_tpu_torch.cli.main <command> "
              "[options]\n\ncommands:")
        for name, spec in sorted(COMMANDS.items()):
            print(f"  {name:24s} {spec[1]}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r} (see --help)")
        return 2
    spec = COMMANDS[cmd]
    mod = importlib.import_module(spec[0])
    entry = getattr(mod, spec[2]) if len(spec) > 2 else mod.main
    return entry(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
