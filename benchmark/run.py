"""The benchmark of tomatis_tpu_torch, one cell per run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--rehearse]

from the root of a checkout. The cell (benchmark/workloads/<cell>.json)
names its configuration, traffic mix, entry driver and limits; the
metrics it reports are BENCHMARK.json's. A run makes its inputs from the
seed, warms the cell's shapes with one short job, then runs whole jobs back
to back for at least --seconds (the window ends with the first job that
finishes at or after it), then holds the outputs to the plain reference.
With --trace 0 the last line of standard output carries the cell's
end-to-end metrics, with --trace 1 its per-layer ones, from a
torch.profiler trace of the window. The numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exit codes: 0 a result was printed; 2 no CUDA card, or fewer than the cell
asks for; 3 a JAX module was loaded; 1 anything else (no result).

--rehearse drives the cell on the CPU at a twentieth of its lengths and
64 frames a chunk (so that every file, a batch's lanes too, spans several
chunks), with the kernels' plain versions: paths, shapes and the last
line are checked, and no device metric is printed.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _process_age() -> float:
    """Seconds since this process started (/proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
BUILD = os.path.join(BENCH, "_build")
FORBIDDEN = ("jax", "jaxlib", "flax", "tomatis_tpu")
REHEARSE_SCALE, REHEARSE_FRAMES = 1 / 20, 64


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own native builds already go to
    tomatis_tpu_torch/native/build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(BUILD, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import spec
    cell = spec.load_cell(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < chips):
        log(f"no result: the cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    workdir = tempfile.mkdtemp(prefix=f"bench-{cell.name}-")
    try:
        return run_cell(cell, args, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_cell(cell, args, workdir: str) -> int:
    import torch

    import tomatis_tpu_torch  # noqa: F401  the program: no program, no run
    from harness import check, counters, driving, spec
    from harness.inputs import Inputs
    from harness.record import Run
    from harness.trace import DeviceTrace, Spans

    rehearse = args.rehearse
    cuda = not rehearse
    if rehearse:
        torch.set_num_threads(2)
    frames = (REHEARSE_FRAMES if rehearse
              else int(cell.config["frames_per_chunk"]))
    inputs = Inputs(cell, args.seed, workdir,
                    REHEARSE_SCALE if rehearse else 1.0)
    spans = Spans(profile=bool(args.trace) and cuda)
    ctx = driving.Context(cell, inputs, workdir, "cuda" if cuda else "cpu",
                          spans, args.seed, frames)
    driver = spec.load_module("drivers", cell.workload["driver"]).make(ctx)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    before = counters.snapshot()
    trace = DeviceTrace() if args.trace and cuda else None
    if trace is not None:
        trace.start()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    jobs = []
    while True:
        jobs.append(driver.job(len(jobs)))
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    if trace is not None:
        trace.stop()
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    run = Run(cell, ctx, setup_s, window_s, jobs,
              counters.diff(before, counters.snapshot()), trace, peak)
    if trace is not None and not trace.intervals:
        log("no result: the trace of the window holds no device event")
        return 1

    rows = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in rows:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None and not (rehearse
                                      and m["source"] == "device_trace"):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        log(f"no result: JAX modules loaded in the benchmark: {bad}")
        return 3

    failed = [j for j in jobs if j.failed]
    details = {
        "cell": cell.name, "seed": args.seed, "rehearsal": rehearse,
        "card": power_limit() if cuda else "cpu rehearsal",
        "jobs": [[j.index, round(j.wall_s, 6), j.audio_s] for j in jobs],
        "failures": [j.failed for j in failed][:3],
        "window_s": window_s, "setup_s": setup_s,
        "bytes_written": sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(workdir) for f in fs),
        "counters": {k: ({str(kk): vv for kk, vv in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in run.counters.items()},
    }
    log("run: " + json.dumps(details, default=str))

    # the check: the program's state freed, the peak read, then the
    # reference on the outputs of the timed path
    answers = driver.answers(jobs)
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    each: list = []
    numbers = check.compare(answers, inputs, cell.config, each=each)
    ok, checks = check.judge(numbers, cell.workload.get("limits", {}))
    for name, nums, masked in each:
        log(f"answer {name}: " + " ".join(f"{k}={v!r}"
                                          for k, v in nums.items())
            + f" masked_frames={masked}")
    log(f"check: {len(answers)} output(s) against the reference in "
        f"{time.perf_counter() - t_check:.1f} s")
    bad = forbidden_modules()
    if bad:
        log(f"no result: JAX modules loaded in the benchmark: {bad}")
        return 3

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "rehearsal",
              "count": int(cell.workload["chips"]) if cuda else 0,
              "memory_peak_bytes": peak}
    result = {"correct": ok and not failed and bool(answers),
              "attempted": len(jobs), "failed": len(failed),
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps(spans.rows)}
    if rehearse:
        result["rehearsal"] = True
    result["checks"] = checks
    for k, c in checks.items():
        v = c["value"]
        v = v if isinstance(v, str) or not math.isfinite(v) else repr(v)
        log(f"check {k} {v} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
