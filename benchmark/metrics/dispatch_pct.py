"""dispatch_pct: the sum over the window's jobs of stats["timings"]["dispatch_compute_s"], as
a percentage of the window's wall time. Layer stream chunk step: the chunk step's enqueue and the pipeline's S1/S2 (StreamRunner.run's dispatch_compute_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["dispatch_compute_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "dispatch_compute_s"))
