"""audit_gate_pct: the sum over the window's jobs and both verifiers of
stats["audit"][tool]["timings"]["gate_s"], as a percentage of the
window's wall time. Layer audit gate: the engineering checks, the state
CSV's read (the validator), the input's upload and frame levels on the
device, their read-back, the gate scan and its statistics (verify.gate
spans of utils/trace.py, children verify.levels and verify.gate_scan)."""
from harness.audit import tool_sum
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'stats["audit"][tool]["timings"]["gate_s"] of each job, both tools'


def read(run):
    return share_of_window(run, tool_sum(run, "timings", "gate_s"))
