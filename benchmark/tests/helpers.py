"""Shared by the benchmark's tests: run benchmark/run.py in this process
(the harness's look for a card skipped by --rehearse) and read its last
line."""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def run_module():
    name = "bench_run_main"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(BENCH, "run.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def rehearse(capsys, cell: str, seed: int = 7, seconds: float = 1.0,
             trace: int = 0) -> tuple:
    """(exit code, the last line of standard output as JSON or None)."""
    rc = run_module().main(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace",
                            str(trace), "--rehearse"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
