"""CLI dispatcher of the PyTorch port:
`python -m tomatis_tpu_torch.cli.main <command> ...`.

`process`, `process-xfade` and `convert` are ported so far; the other
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
