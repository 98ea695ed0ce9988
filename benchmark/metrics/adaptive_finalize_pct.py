"""adaptive_finalize_pct: the sum over the window's jobs of
stats["timings"]["restore_protect_s"], as a percentage of the window's
wall time. Layer adaptive output: the adaptive processor's global peak
protect (adaptive.finalize spans of utils/trace.py): the staging file read
back (adaptive.stage_read), rescaled, and encoded to the PCM_24 output
(writer.encode, writer.close)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["restore_protect_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "restore_protect_s"))
