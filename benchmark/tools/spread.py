"""The spread of each cell's metrics over runs kept by tools/runs.py:

    python3 benchmark/tools/spread.py chiprun_out/setA.jsonl [more.jsonl]

Per cell and metric: the median, the runs, and the spread, the distance
between the first and third quartiles of statistics.quantiles(values,
n=4) as a share of the median, over all runs and per set (the runs of
each file); "tight" is the mean over the sets of the spread with each
set's run farthest from its median left out, as the check reads it to
find a bound too tight. Also each run's `correct` and its compared
numbers, the largest per cell."""
from __future__ import annotations

import argparse
import json
import statistics
from collections import defaultdict


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    """values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    by = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    worst = defaultdict(dict)
    bad = []
    for f in args.files:
        for line in open(f):
            r = json.loads(line)
            res = r.get("result")
            if not res:
                bad.append((r["cell"], r["seed"], r["rc"]))
                continue
            if not res["correct"]:
                bad.append((r["cell"], r["seed"], "not correct"))
            for k, m in res["metrics"].items():
                by[r["cell"]][k][f].append(m["value"])
            for k, c in res.get("checks", {}).items():
                v = c["value"]
                v = float(v) if not isinstance(v, str) else float("inf")
                worst[r["cell"]][k] = max(worst[r["cell"]].get(k, v), v)
    for cell, metrics in by.items():
        print(cell)
        for k, sets in metrics.items():
            allv = [v for vs in sets.values() for v in vs]
            parts = " ".join(f"set{i}={spread(vs):.4f}(n={len(vs)})"
                             for i, vs in enumerate(sets.values()))
            tight = statistics.mean(spread(trimmed(vs))
                                    for vs in sets.values())
            meds = " ".join(f"{statistics.median(vs):.6g}"
                            for vs in sets.values())
            print(f"  {k}: median {statistics.median(allv):.6g} "
                  f"(sets {meds}) min {min(allv):.6g} max {max(allv):.6g} "
                  f"all={spread(allv):.4f}(n={len(allv)}) {parts} "
                  f"tight={tight:.4f}")
        print(f"  largest compared numbers: {worst[cell]}")
    if bad:
        print("runs without a correct result:", bad)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
