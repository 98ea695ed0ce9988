"""audit_spectrum_frame_us: the conditional spectrum's cost per frame, in
microseconds: the sum over the window's jobs and both verifiers of
stats["audit"][tool]["timings"]["spectrum_s"] (verify.spectrum spans of
utils/trace.py) over the sum of their counters["spectrum_frames"] (the
frames whose ratios were computed, both states, before the -60 dBFS
keep). Layer audit spectrum."""
from harness.audit import tool_sum

UNIT, SOURCE, MOVES = "us", "program_span", "device_ms_per_audio_min"
READS = ('stats["audit"][tool]["timings"]["spectrum_s"] over '
         'stats["audit"][tool]["counters"]["spectrum_frames"], both tools')


def read(run):
    s = tool_sum(run, "timings", "spectrum_s")
    n = tool_sum(run, "counters", "spectrum_frames")
    return None if s is None or not n else 1e6 * s / n
