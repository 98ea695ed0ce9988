"""producer_decode_pct: the sum over the window's jobs of stats["timings"]["decode_s"], as
a percentage of the window's wall time. Layer stream producer: the producer thread's reads of the source
(the FLAC decode and its int or float conversion; producer.decode spans of utils/trace.py)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["decode_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "decode_s"))
