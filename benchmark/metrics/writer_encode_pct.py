"""writer_encode_pct: the sum over the window's jobs of stats["timings"]["encode_s"], as
a percentage of the window's wall time. Layer writer: the sink's writes (for FLAC the le24 unpack and
the native encode, writer.encode spans, on the writer thread and in the final drain) and the encoder's
close (writer.close), from the program's span recorder (utils/trace.py)."""
from harness.readers import share_of_window, stage_seconds

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'stats["timings"]["encode_s"] of each job'


def read(run):
    return share_of_window(run, stage_seconds(run, "encode_s"))
