"""array_collect_pct: the sum over the window's jobs of stats["timings"]["output_decode_s"], as
a percentage of the window's wall time. Layer array collect: run_array's join of the flushes and its decode (output_decode_s)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["output_decode_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "output_decode_s"))
