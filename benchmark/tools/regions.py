"""A cell's run, as benchmark/run.py makes it, that also splits each file
answer's sample gaps by region: the first hop of the stream (under the
first frame's window alone), the interior up to the reference's last_cut,
and the end from there; with the sample that holds the output's peak, in
the program's answer and in the reference, and the region it lies in:

    python3 benchmark/tools/regions.py --workload adaptive.flac_10min \
        --seed 1 --seconds 30 --trace 0

Arguments, result line and exit code are run.py's; the split goes to
standard error as one `regions <answer>: ...` line per answer, with the
reference's `search` summary where it returns one (the adaptive
reference: threshold, probes, ambiguous_probes). Nothing is compared to a
limit here: the check is run.py's."""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _region(i: int, head_end: int, cut: int) -> str:
    return "head" if i < head_end else ("interior" if i < cut else "end")


def split(a, ref: dict, n_fft: int, gap_mask) -> str | None:
    """The regions line of answer a (a file's PCM values) against ref."""
    got, want = a.pcm, ref["pcm"]
    if got is None or got.shape != want.shape or not len(want):
        return None
    gap = np.abs(got.astype(np.int64) - want).max(axis=1)
    gap = np.where(gap_mask(ref, len(gap), n_fft), gap, 0)
    starts = ref["starts"]
    hop = int(starts[1] - starts[0]) if len(starts) > 1 else n_fft
    head_end = max(0, min(len(gap), int(starts[0]) + hop))
    cut = ref["last_cut"]
    peak = int(np.abs(got).max(axis=1).argmax())
    ref_peak = int(np.abs(want).max(axis=1).argmax())
    fields = {
        "head_lsb": float(gap[:head_end].max(initial=0)),
        "interior_lsb": float(gap[head_end:cut].max(initial=0)),
        "end_lsb": float(gap[cut:].max(initial=0)),
        "head_end": head_end, "last_cut": int(cut), "total": len(gap),
        "peak_sample": peak, "peak_region": _region(peak, head_end, cut),
        "ref_peak_sample": ref_peak,
        "ref_peak_region": _region(ref_peak, head_end, cut),
        "masked_frames": int(np.sum(ref["masked"])),
    }
    fields.update(ref.get("search") or {})
    return " ".join(f"{k}={v!r}" for k, v in fields.items())


def main(argv=None) -> int:
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import check
    audio_gaps = check._audio_gaps

    def gaps(a, ref, n_fft):
        line = split(a, ref, n_fft, check._sample_mask)
        if line is not None:
            print(f"regions {a.name}: {line}", file=sys.stderr, flush=True)
        return audio_gaps(a, ref, n_fft)

    check._audio_gaps = gaps
    spec = importlib.util.spec_from_file_location(
        "bench_run_regions", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
