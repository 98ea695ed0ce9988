"""adaptive_pass3_pct: the sum over the window's jobs of
stats["timings"]["pass3_s"], as a percentage of the window's wall time.
Layer adaptive stream: the adaptive processor's third pass (adaptive.pass3
spans of utils/trace.py): the input's third read, the floor8/f32 chunk
step and its read-back (adaptive.step), and the float32 staging writes
(adaptive.stage_write)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["pass3_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "pass3_s"))
