"""Run cells one after another, each run its own process, as the
benchmark's check runs them, and keep what each printed:

    python3 benchmark/tools/runs.py --out chiprun_out/runs.jsonl \
        standard.flac_10min:1001:30:0 standard.flac_10min:1002:30:1 ...

Each argument is cell:seed:seconds:trace. One JSON line per run goes to
--out: the arguments, the exit code, the wall time, the result line and
the last lines of standard error. Run it on the machine that holds the
card, never beside another run on that card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(os.path.dirname(HERE), "run.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=360.0)
    ap.add_argument("runs", nargs="+", help="cell:seed:seconds:trace")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    worst = 0
    for spec_ in args.runs:
        cell, seed, seconds, trace = spec_.rsplit(":", 3)
        cmd = [sys.executable, RUN, "--workload", cell, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t0
        lines = out.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"cell": cell, "seed": int(seed), "seconds": float(seconds),
               "trace": int(trace), "rc": rc, "wall_s": wall,
               "result": result, "stderr": err[-6000:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        summary = (result or {}).get("metrics", {})
        print(f"{cell} seed={seed} trace={trace} rc={rc} wall={wall:.1f}s "
              f"correct={(result or {}).get('correct')} "
              + " ".join(f"{k}={v['value']:.6g}" for k, v in summary.items()),
              flush=True)
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
