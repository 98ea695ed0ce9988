"""audit_spectrum_pct: the sum over the window's jobs and both verifiers of
stats["audit"][tool]["timings"]["spectrum_s"], as a percentage of the
window's wall time. Layer audit spectrum: both signals' uploads, the
stable frames gathered on the device, their rFFTs and |Y|/|X| ratios
(verify.ratios), the read-back and the host's per-bin medians
(verify.median), the theory curves and metrics (verify.spectrum spans of
utils/trace.py)."""
from harness.audit import tool_sum
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["audit"][tool]["timings"]["spectrum_s"] of each job, both tools'


def read(run):
    return share_of_window(run, tool_sum(run, "timings", "spectrum_s"))
