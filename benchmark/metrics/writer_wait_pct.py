"""writer_wait_pct: the sum over the window's jobs of stats["timings"]["consume_s"], as
a percentage of the window's wall time. Layer writer: the calling thread's wait on the ordered writer (StreamRunner.run's consume_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["timings"]["consume_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "consume_s"))
