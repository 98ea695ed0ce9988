"""realtime_x.per_layer: realtime_x (metrics/realtime_x.py), seconds of
input audio whose complete output the entry returned over the window's
wall time, read per layer in the cells where the spread of the host's
clock between runs keeps it off the gate (PERF.md, section 2). Layer
entry."""
UNIT, SOURCE, MOVES = "audio-s/s", "host_clock", "device_ms_per_audio_min"
READS = "the window's wall time and each job's input seconds"


def read(run):
    if run.window_s <= 0:
        return None
    return sum(j.audio_s for j in run.jobs) / run.window_s
