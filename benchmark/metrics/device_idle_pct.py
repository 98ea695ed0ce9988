"""device_idle_pct: 100 x (1 - the union of the device's kernel, copy and
set intervals / the traced window), from torch.profiler (CUPTI). Layer
device. A traced run on the card that records no device event fails in
run.py; nothing is read without a trace."""
UNIT, SOURCE, MOVES = "%", "device_trace", "realtime_x"
READS = "every CUDA event of the window's trace"


def read(run):
    if run.trace is None or not run.trace.intervals:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
