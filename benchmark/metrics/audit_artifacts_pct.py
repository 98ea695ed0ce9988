"""audit_artifacts_pct: the sum over the window's jobs and both verifiers
of stats["audit"][tool]["timings"]["artifacts_s"], as a percentage of the
window's wall time. Layer audit output: the spectrum CSVs, the
verifier's report and the PNGs where matplotlib imports
(verify.artifacts spans of utils/trace.py)."""
from harness.audit import tool_sum
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = ('stats["audit"][tool]["timings"]["artifacts_s"] of each job, '
         'both tools')


def read(run):
    return share_of_window(run, tool_sum(run, "timings", "artifacts_s"))
