"""setup_s: process start to window start: imports, CUDA, the native
libraries, the inputs made from the seed, one warm job; where the window
is traced, not the profiler's start (the benchmark's, not the program's)."""
UNIT, SOURCE = "s", "host_clock"
READS = "the host clock from the process's start to the window's"


def read(run):
    return run.setup_s
