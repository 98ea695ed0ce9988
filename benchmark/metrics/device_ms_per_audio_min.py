"""device_ms_per_audio_min: milliseconds of device time per minute of
input audio whose complete output the window returned: the union of the
device's kernel, copy and set intervals over the traced window
(torch.profiler, CUPTI), over the window's audio. What a conversion costs
the card, and so how many conversions one card carries side by side.
Nothing is read without a trace or without audio."""
UNIT, SOURCE = "ms/audio-min", "device_trace"
READS = "every CUDA event of the window's trace and each job's input seconds"


def read(run):
    audio = sum(j.audio_s for j in run.jobs)
    if run.trace is None or not run.trace.intervals or audio <= 0:
        return None
    return 1000.0 * run.trace.busy_s() / (audio / 60.0)
