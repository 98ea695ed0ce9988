"""realtime_x: seconds of input audio whose complete output the entry
returned, over the wall time of the window (every job of the window,
failed ones adding no audio)."""
UNIT, SOURCE = "audio-s/s", "host_clock"
READS = "the window's wall time and each job's input seconds"


def read(run):
    if run.window_s <= 0:
        return None
    return sum(j.audio_s for j in run.jobs) / run.window_s
