"""CLI dispatcher of the PyTorch port:
`python -m tomatis_tpu_torch.cli.main <command> ...`.

The three processors, the EQ appliers, the repair tools and the
device-matching workflow with its analysis commands are ported; the other
commands of tomatis_tpu/cli/main.py are queued in ROADMAP.md.
"""
from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "process": ("tomatis_tpu_torch.cli.process",
                "standard gate-controlled C1/C2 tilt processor"),
    "process-xfade": ("tomatis_tpu_torch.cli.process_xfade",
                      "processor with crossfade state transitions"),
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
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m tomatis_tpu_torch.cli.main <command> "
              "[options]\n\ncommands:")
        for name, (_, doc) in sorted(COMMANDS.items()):
            print(f"  {name:24s} {doc}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r} (see --help)")
        return 2
    return importlib.import_module(COMMANDS[cmd][0]).main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
