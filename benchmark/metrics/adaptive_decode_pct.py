"""adaptive_decode_pct: the sum over the window's jobs of
stats["timings"]["decode_s"], as a percentage of the window's wall time.
Layer adaptive input: the adaptive processor's reads of its input file
(the FLAC decode and the float conversion; adaptive.decode spans of
utils/trace.py) in all three passes. Each pass's span holds its own reads,
so this share overlaps adaptive_pass3_pct and the peak scan's and the
levels' time."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = ('stats["timings"]["decode_s"] of each job: the reads of passes 1-3, '
         'inside each pass\'s own span (the shares overlap)')


def read(run):
    return share_of_window(run, stage_seconds(run, "decode_s"))
