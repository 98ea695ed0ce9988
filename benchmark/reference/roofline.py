"""The yardstick's peak and the bytes a kernel must move.

HBM_BYTES_PER_S: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet,
at the full 700 W power limit; tools/l2_probe.py and PERF.md state the
kernels' rates as shares of it, with the card's power limit beside them.

tail_bytes and batched_tail_bytes are frozen copies of chip_smoke.py's:
each input byte read once (the frames z, win, win2, the carried tails, the
gain), each output byte written once (the normalised span, the carries
and, for pcm24, the per-hop-block peaks and the PCM_24 bytes), for a
launch over F frames whatever its n_valid: the kernel reads and writes the
whole span of every launch, an idle batch lane's too.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def tail_bytes(F: int, C: int, n_fft: int, hop: int, transport: str) -> int:
    """One chunk_tail_cuda launch over F frames of C channels."""
    k, tail = n_fft // hop, n_fft - hop
    L, W = (F + k - 1) * hop, F + k - 1
    b = 4 * (F * C * n_fft + 2 * n_fft + tail * C + tail)
    b += 4 * (L * C + tail * C + tail)
    if transport == "pcm24":
        b += 4 + 4 * W + 3 * L * C
    return b


def batched_tail_bytes(B: int, F: int, C: int, n_fft: int, hop: int,
                       transport: str) -> int:
    """One chunk_tail_batched_cuda launch over B lanes: each lane's frames,
    tails and outputs, the shared windows and gain once, each lane's
    n_valid."""
    shared = 4 * 2 * n_fft + (4 if transport == "pcm24" else 0)
    return B * (tail_bytes(F, C, n_fft, hop, transport) - shared) \
        + shared + 4 * B
