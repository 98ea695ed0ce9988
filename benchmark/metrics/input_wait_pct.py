"""input_wait_pct: the sum over the window's jobs of stats["timings"]["input_host_s"], as
a percentage of the window's wall time. Layer stream producer: the calling thread's wait for the producer and the upload (StreamRunner.run's input_host_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["input_host_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "input_host_s"))
