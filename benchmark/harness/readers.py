"""Helpers the metric readers (metrics/<name>.py) share. A reader is
read(run) -> float or None, where run is harness.record.Run; None means
the run holds nothing to read, and the metric is left out of the line."""
from __future__ import annotations


def stage_seconds(run, key: str):
    """The sum over the window's jobs of the program's
    stats["timings"][key] (StreamRunner.run's stage timers, with
    run_array's and process_file's additions; LAST_TIMINGS for a batch),
    or None where no job reports it."""
    vals = [j.stats["timings"][key] for j in run.jobs
            if isinstance(j.stats, dict)
            and key in (j.stats.get("timings") or {})]
    return sum(vals) if vals else None


def share_of_window(run, seconds):
    """seconds as a percentage of the window's wall time."""
    if seconds is None or run.window_s <= 0:
        return None
    return 100.0 * seconds / run.window_s


def is_chunk_tail(name: str, batched: bool) -> bool:
    """A device operation of ops/cuda_ola.py's fused chunk tail, the
    batched or the single-file form (csrc/ola.cu's chunk_tail_kernel
    template, its last argument BATCHED; demangled or mangled)."""
    if "chunk_tail_kernel" not in name:
        return False
    is_batched = "true>" in name or "Lb1E" in name
    return is_batched == batched
