"""chunk_tail_batched_gbps: the batched fused chunk tail
(ops/cuda_ola.py chunk_tail_batched_cuda -> csrc/ola.cu), the bytes its
launches in the window must move (reference/roofline.py
batched_tail_bytes for the batch's B lanes and frames per chunk, times the
launches the program counted, chunk_tail_batched_cuda.launches, one
variant) over the kernel's device time in the trace, in GB/s. Layer
kernel. As chunk_tail_gbps, a rate and not a roofline share: the lanes'
frames come from cuFFT just before, partly from L2."""
from harness.readers import is_chunk_tail
from reference.roofline import batched_tail_bytes

UNIT, SOURCE, MOVES = "GB/s", "device_trace", "realtime_x"
READS = "chunk_tail_batched_cuda.launches and .by_variant; chunk_tail_kernel (batched) device time"


def read(run):
    launches = run.counters.get("chunk_tail_batched.launches")
    by_variant = run.counters.get("chunk_tail_batched.by_variant")
    if run.trace is None or not launches or not by_variant \
            or len(by_variant) != 1:
        return None
    (_norm, transport, C), = by_variant.keys()
    p = run.cell.config["params"]
    B, F = len(run.ctx.inputs), run.ctx.frames_per_chunk
    nbytes = launches * batched_tail_bytes(B, F, C, p["n_fft"], p["hop"],
                                           transport)
    sec, count = run.trace.seconds_of(lambda n: is_chunk_tail(n, True))
    if sec <= 0 or count != launches:
        return None
    return nbytes / sec / 1e9
