"""batch_read_pct: the sum over the window's jobs of stats["timings"]["read_s"], as
a percentage of the window's wall time. Layer batch: the producer's wall time in the lanes' reads (parallel.batch.LAST_TIMINGS read_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["timings"]["read_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "read_s"))
