"""What an entry driver (drivers/<name>.py) gets and gives back.

A driver module has make(ctx) -> an object with
  warm()          one short job through the same entry (set-up)
  job(k)          the window's k-th job -> Job
  answers(jobs)   after the window: the outputs the check compares,
                  as harness.check.Answer
  release()       drop the program's state before the reference runs
"""
from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from harness import spec
from harness.check import Answer, read_state_csv
from harness.inputs import Inputs
from harness.trace import Spans


@dataclass
class Context:
    cell: spec.Cell
    inputs: Inputs
    workdir: str
    device: str
    spans: Spans
    seed: int
    frames_per_chunk: int


@dataclass
class Job:
    """One job of the window. audio_s counts only when it succeeded.
    outputs: (input index, audio file, state CSV or None) it wrote, or
    (input index, array) it returned, for the check."""
    index: int
    audio_s: float
    wall_s: float
    stats: object = None
    failed: str | None = None
    outputs: list = field(default_factory=list)


def timed_job(k: int, spans: Spans, name: str, fn) -> Job:
    """Run fn() -> (audio_s, stats, outputs) as job k; an exception is a
    failed job."""
    t0 = time.perf_counter()
    try:
        with spans.span(name):
            audio_s, stats, outputs = fn()
        failed = None
    except Exception as e:          # a failed job is counted, not fatal
        audio_s, stats, outputs, failed = 0.0, None, [], repr(e)
    return Job(k, audio_s if failed is None else 0.0,
               time.perf_counter() - t0, stats, failed, outputs)


def program_params(config: dict):
    """The processor's params dataclass, as the configuration states."""
    if config["processor"] == "standard":
        from tomatis_tpu_torch.models.standard import StandardParams
        return StandardParams(**config["params"])
    if config["processor"] == "xfade":
        from tomatis_tpu_torch.models.xfade import XfadeParams
        return XfadeParams(**config["params"])
    raise ValueError(f"no driver for processor {config['processor']!r}")


EMPTY_CSV = {"frame_idx": np.zeros(0, np.int64), "level": np.zeros(0),
             "state": np.zeros(0, "<U2")}


def _digest(path: str | None) -> str:
    if path is None or not os.path.exists(path):
        return ""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 22), b""):
            h.update(blk)
    return h.hexdigest()


def file_answers(jobs: list) -> list:
    """Every output file the window's jobs wrote, judged once per distinct
    content: equal bytes are the same answer."""
    from reference import flaccodec
    outs = [(j.index, o) for j in jobs for o in j.outputs]
    with ThreadPoolExecutor(8) as pool:
        keys = list(pool.map(lambda io: (io[1][0], _digest(io[1][1]),
                                         _digest(io[1][2])), outs))
    distinct = {}
    for (k, o), key in zip(outs, keys):
        distinct.setdefault(key, (k, o))

    def load(item):
        k, (i, audio_path, csv_path) = item
        try:
            pcm, _, _ = flaccodec.decode(audio_path)
        except OSError:             # no file, or not one: no samples
            pcm = np.zeros((0, 0), np.int32)
        try:
            table = read_state_csv(csv_path) if csv_path else None
        except (OSError, KeyError, ValueError):
            table = EMPTY_CSV
        return Answer(f"job{k}:{os.path.basename(audio_path)}", i, pcm=pcm,
                      csv=table)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(load, distinct.values()))


def sample_indices(seed: int, first: int, draws: int) -> set:
    """Job indices whose outputs an in-memory driver keeps for the check,
    drawn from the seed among the first `first` jobs (the last job is
    kept besides)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    return set(int(v) for v in rng.integers(0, first, draws))
