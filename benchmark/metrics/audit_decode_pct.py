"""audit_decode_pct: the sum over the window's jobs and both verifiers of
stats["audit"][tool]["timings"]["decode_s"], as a percentage of the
window's wall time. Layer audit input: each verifier's two whole-file
reads, the input and the processed output (io/audio.py::read through the
native FLAC reader; verify.decode spans of utils/trace.py)."""
from harness.audit import tool_sum
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["audit"][tool]["timings"]["decode_s"] of each job, both tools'


def read(run):
    return share_of_window(run, tool_sum(run, "timings", "decode_s"))
