"""job_setup_ms: the mean per job of the program's own set-up timer,
stats["timings"]["runner_setup_s"] (the runner's construction in
process_file / run_array, and StreamRunner.run's carries, reader and
helper threads), in ms. Layer: entry."""
from harness.readers import stage_seconds

UNIT, SOURCE, MOVES = "ms", "program_span", "realtime_x"
READS = 'stats["timings"]["runner_setup_s"] of each job'


def read(run):
    s = stage_seconds(run, "runner_setup_s")
    n = sum(1 for j in run.jobs if isinstance(j.stats, dict)
            and "runner_setup_s" in (j.stats.get("timings") or {}))
    return None if s is None or n == 0 else 1000.0 * s / n
