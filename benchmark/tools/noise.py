"""Where the spread between runs comes from: runs of one cell, each its own
process as the check runs them, in turns under the environments named,
with what the host did meanwhile:

    python3 benchmark/tools/noise.py --out chiprun_out/noise.jsonl \
        --variants base omp1 --rounds 3 xfade.array_10min:4001:10

For each run, one JSON line: the variant, the result's metrics, the jobs'
walls, the child's resource use (CPU seconds, page faults, context
switches) and the host's CPU time by kind over the run from /proc/stat
(steal is time a virtual CPU waited for the host), with the CPU clock.
Run it on the machine that holds the card, never beside another run."""
from __future__ import annotations

import argparse
import json
import os
import re
import resource
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(os.path.dirname(HERE), "run.py")
VARIANTS = {
    "base": {},
    # one thread for torch's and OpenMP's CPU pools
    "omp1": {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"},
    # glibc's malloc asks for transparent huge pages for its mappings
    "thp": {"GLIBC_TUNABLES": "glibc.malloc.hugetlb=1"},
}
RUSAGE = ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt", "ru_nvcsw",
          "ru_nivcsw")
STAT_KEYS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")


def host_cpu() -> dict:
    with open("/proc/stat") as f:
        vals = f.readline().split()[1:1 + len(STAT_KEYS)]
    return dict(zip(STAT_KEYS, map(int, vals)))


def cpu_mhz() -> float:
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(v) for v in re.findall(r"cpu MHz\s*:\s*([\d.]+)",
                                                f.read())]
        return sum(mhz) / len(mhz) if mhz else 0.0
    except OSError:
        return 0.0


def one(cell: str, seed: str, seconds: str, env: dict) -> dict:
    cmd = [sys.executable, RUN, "--workload", cell, "--seed", seed,
           "--seconds", seconds, "--trace", "0"]
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    a, mhz0, t0 = host_cpu(), cpu_mhz(), time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, **env))
    out, err = p.stdout, p.stderr
    wall = time.perf_counter() - t0
    b = host_cpu()
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    ru = {k: getattr(r1, k) - getattr(r0, k) for k in RUSAGE}
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        result = {}
    m = re.search(r"^run: (.*)$", err, re.M)
    jobs = [j[1] for j in json.loads(m.group(1))["jobs"]] if m else []
    ticks = {k: b[k] - a[k] for k in STAT_KEYS}
    total = max(1, sum(ticks.values()))
    return {"rc": p.returncode, "wall_s": wall,
            "metrics": {k: v["value"]
                        for k, v in result.get("metrics", {}).items()},
            "correct": result.get("correct"), "jobs_s": jobs,
            "host_pct": {k: 100.0 * v / total for k, v in ticks.items()},
            "cpu_mhz": [mhz0, cpu_mhz()], "rusage": ru}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--variants", nargs="+", default=["base"],
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("run", help="cell:seed:seconds")
    args = ap.parse_args(argv)
    cell, seed, seconds = args.run.rsplit(":", 2)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for r in range(args.rounds):
        for v in args.variants:
            row = one(cell, seed, seconds, VARIANTS[v])
            row.update(variant=v, round=r, cell=cell, seed=int(seed))
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            ru = row["rusage"]
            print(f"{v} round {r}: rc={row['rc']} "
                  f"realtime_x={row['metrics'].get('realtime_x', 0):.6g} "
                  f"setup_s={row['metrics'].get('setup_s', 0):.4g} "
                  f"cpu_s={ru['ru_utime'] + ru['ru_stime']:.2f} "
                  f"minflt={ru['ru_minflt']} nivcsw={ru['ru_nivcsw']} "
                  f"steal%={row['host_pct']['steal']:.2f} "
                  f"mhz={row['cpu_mhz'][1]:.0f} "
                  f"jobs={[round(j, 3) for j in row['jobs_s']]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
