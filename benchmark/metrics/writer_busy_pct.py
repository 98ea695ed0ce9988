"""writer_busy_pct: the sum over the window's jobs of stats["timings"]["writer_busy_s"], as
a percentage of the window's wall time. Layer writer: the writer thread's busy time, each chunk's whole
host half (routing, CSV rows, flush-cut drain and the sink's writes; writer.job spans of utils/trace.py)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["timings"]["writer_busy_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "writer_busy_s"))
