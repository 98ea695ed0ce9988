"""How much of the chunk tail's in-stream rate comes from L2: the
program's chunk_tail_cuda at the production shape (1024 frames, stereo,
n_fft 4096, hop 2048, pcm24), timed from the CUPTI trace as the
chunk_tail_gbps metric times it, in three settings:

  stream   its frames z fresh from cuFFT's irFFT, as the chunk step
           gives them
  flushed  the same, with 256 MB written between the irFFT and the
           launch, so that nothing of z is left in the 50 MB L2
  repeat   launches back to back on one z, each after the last

    python3 benchmark/tools/l2_probe.py [--iters 30]

Prints one JSON line: per setting the mean kernel time, the bytes it must
move (reference/roofline.py) over it in GB/s, and that as a share of
HBM_BYTES_PER_S. Needs the card."""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness.readers import is_chunk_tail  # noqa: E402
from harness.trace import DeviceTrace  # noqa: E402
from reference.roofline import HBM_BYTES_PER_S, tail_bytes  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    from tomatis_tpu_torch.ops import cuda_ola
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    F, C, n_fft, hop = 1024, 2, 4096, 2048
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    spec = torch.randn((F, C, n_fft // 2 + 1), dtype=torch.complex64,
                       generator=g, device=dev)
    win = torch.hann_window(n_fft, periodic=False, device=dev)
    kw = dict(win=win, win2=win * win, n_valid=F,
              out_tail=torch.zeros((n_fft - hop, C), device=dev),
              w_tail=torch.zeros((n_fft - hop,), device=dev),
              gain_lin=torch.ones((), device=dev), transport="pcm24")
    junk = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    nbytes = tail_bytes(F, C, n_fft, hop, "pcm24")

    def stream():
        cuda_ola.chunk_tail_cuda(torch.fft.irfft(spec, n=n_fft), **kw)

    def flushed():
        z = torch.fft.irfft(spec, n=n_fft)
        junk.fill_(1.0)
        cuda_ola.chunk_tail_cuda(z, **kw)

    z0 = torch.fft.irfft(spec, n=n_fft)

    def repeat():
        cuda_ola.chunk_tail_cuda(z0, **kw)

    out = {"card": torch.cuda.get_device_name(0), "bytes": nbytes}
    for name, fn in (("stream", stream), ("flushed", flushed),
                     ("repeat", repeat)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        tr = DeviceTrace()
        tr.start()
        for _ in range(args.iters):
            fn()
        tr.stop()
        sec, count = tr.seconds_of(lambda n: is_chunk_tail(n, False))
        t = sec / max(count, 1)
        out[name] = {"launches": count, "kernel_ms": t * 1e3,
                     "gbps": nbytes / t / 1e9,
                     "hbm_pct": 100.0 * nbytes / t / HBM_BYTES_PER_S}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
