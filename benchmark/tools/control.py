"""The control's readings at the cells' own sizes: for each cell and seed,
the inputs made as a run makes them, the lower-precision control
(harness/control.py) in the program's place, and the numbers the check
compares, printed as one JSON line each beside the cell's limits:

    python3 benchmark/tools/control.py --seeds 11 12 13 \
        --out chiprun_out/control.jsonl standard.flac_10min ...

The control has to fail: at least one number over its limit in every
cell. No program code runs here."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import check, control, spec  # noqa: E402
from harness.inputs import Inputs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    passed = 0
    for name in args.cells:
        cell = spec.load_cell(name)
        for seed in args.seeds:
            d = tempfile.mkdtemp(prefix="bench-control-")
            try:
                t0 = time.perf_counter()
                inputs = Inputs(cell, seed, d)
                nums = check.compare(
                    control.answers(inputs, cell.config, own=cell.numbers),
                    inputs, cell.config, own=cell.numbers)
                ok, checks = check.judge(nums, cell.workload["limits"])
            finally:
                shutil.rmtree(d, ignore_errors=True)
            row = {"cell": name, "seed": seed, "control_correct": ok, "checks": checks,
                   "seconds": time.perf_counter() - t0}
            passed += ok
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
