"""The program's own launch counters, read before and after the window
(tomatis_tpu_torch/ops/cuda_ola.py counts each launch of its kernels, by
variant and, for the single-file chunk tail, by chunk size). A counter
the program does not have is left out, and the metrics that need it
report nothing."""
from __future__ import annotations

import collections

COUNTERS = {
    "chunk_tail.launches": ("chunk_tail_cuda", "launches"),
    "chunk_tail.by_frames": ("chunk_tail_cuda", "by_frames"),
    "chunk_tail.by_variant": ("chunk_tail_cuda", "by_variant"),
    "chunk_tail_batched.launches": ("chunk_tail_batched_cuda", "launches"),
    "chunk_tail_batched.by_variant": ("chunk_tail_batched_cuda",
                                      "by_variant"),
    "overlap_add.launches": ("overlap_add_cuda", "launches"),
}


def snapshot() -> dict:
    from tomatis_tpu_torch.ops import cuda_ola
    out = {}
    for key, (fn, attr) in COUNTERS.items():
        val = getattr(getattr(cuda_ola, fn, None), attr, None)
        if isinstance(val, collections.Counter):
            out[key] = collections.Counter(val)
        elif isinstance(val, int):
            out[key] = val
    return out


def diff(before: dict, after: dict) -> dict:
    out = {}
    for key, val in after.items():
        if key not in before:
            continue
        d = val - before[key]
        out[key] = (collections.Counter({k: v for k, v in d.items() if v})
                    if isinstance(d, collections.Counter) else d)
    return out
