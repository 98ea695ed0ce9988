"""chunk_tail_gbps: the single-file fused chunk tail (ops/cuda_ola.py
chunk_tail_cuda -> csrc/ola.cu), the bytes its launches in the window must
move (reference/roofline.py tail_bytes on the program's counts by chunk
size, chunk_tail_cuda.by_frames, of the one variant the window ran: each
input byte read once, each output byte written once) over the kernel's
device time in the trace, in GB/s. Layer kernel.

Not a share of the HBM roofline: in the stream the frames z come to the
kernel from cuFFT just before, 33.5 MB of its 63 MB at 1024 frames, and
much of them from the 50 MB L2, so the rate can pass HBM's 3,350 GB/s
(reference/roofline.py HBM_BYTES_PER_S); tools/l2_probe.py times the
launch with and without L2 flushed.
Nothing is read where the window ran several variants, or the trace holds
another launch count than the program's counter."""
from harness.readers import is_chunk_tail
from reference.roofline import tail_bytes

UNIT, SOURCE, MOVES = "GB/s", "device_trace", "realtime_x"
READS = "chunk_tail_cuda.by_frames and .by_variant; chunk_tail_kernel device time"


def read(run):
    by_frames = run.counters.get("chunk_tail.by_frames")
    by_variant = run.counters.get("chunk_tail.by_variant")
    if run.trace is None or not by_frames or not by_variant \
            or len(by_variant) != 1:
        return None
    (_norm, transport, C), = by_variant.keys()
    p = run.cell.config["params"]
    nbytes = sum(n * tail_bytes(F, C, p["n_fft"], p["hop"], transport)
                 for F, n in by_frames.items())
    sec, count = run.trace.seconds_of(lambda n: is_chunk_tail(n, False))
    if sec <= 0 or count != sum(by_frames.values()):
        return None
    return nbytes / sec / 1e9
