"""producer_wait_pct: the sum over the window's jobs of stats["timings"]["producer_wait_s"], as
a percentage of the window's wall time. Layer stream producer: the calling thread's wait for the
producer's next chunk (stream.producer_wait spans of utils/trace.py, inside input_host_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["timings"]["producer_wait_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "producer_wait_s"))
