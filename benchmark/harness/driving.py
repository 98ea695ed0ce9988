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

KEEP_ROUNDS = 4


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
    outputs: (input index, audio file, state CSV or None) it wrote, with
    as a fourth element {name: path} of the further files it wrote where
    the cell holds numbers of its own on them (reference/__init__.py);
    or (input index, array) it returned; for the check."""
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
    """The processor's params: the configuration's "params" in the class
    it names under "params_class"."""
    return spec.program_object(config, "params_class")(**config["params"])


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


def _output_key(output: tuple) -> tuple:
    """What makes two outputs the same answer: the input, and the bytes of
    the audio, the state CSV and each further file."""
    i, audio_path, csv_path, *further = output
    files = further[0] if further else {}
    return (i, _digest(audio_path), _digest(csv_path)) + tuple(
        (name, _digest(files[name])) for name in sorted(files))


def file_answers(jobs: list) -> list:
    """Every output file the window's jobs left, judged once per distinct
    content: equal bytes are the same answer. A file that several jobs
    wrote over (OutputSlots) holds, and is named after, the newest."""
    from reference import flaccodec
    newest = {}
    for j in jobs:
        for o in j.outputs:
            i, audio_path, csv_path, *further = o
            files = tuple(sorted(further[0].items())) if further else ()
            newest[(i, audio_path, csv_path, files)] = (j.index, o)
    outs = list(newest.values())
    with ThreadPoolExecutor(8) as pool:
        keys = list(pool.map(lambda io: _output_key(io[1]), outs))
    distinct = {}
    for (k, o), key in zip(outs, keys):
        distinct.setdefault(key, (k, o))

    def load(item):
        k, (i, audio_path, csv_path, *further) = item
        try:
            pcm, _, _ = flaccodec.decode(audio_path)
        except OSError:             # no file, or not one: no samples
            pcm = np.zeros((0, 0), np.int32)
        try:
            table = read_state_csv(csv_path) if csv_path else None
        except (OSError, KeyError, ValueError):
            table = EMPTY_CSV
        return Answer(f"job{k}:{os.path.basename(audio_path)}", i, pcm=pcm,
                      csv=table, files=dict(further[0]) if further else {})

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(load, distinct.values()))


class OutputSlots:
    """Where a file driver's job k writes: of each input, the check keeps
    the outputs of one round drawn from the seed among its first
    KEEP_ROUNDS, and the newest; the input's other jobs write over its one
    slot. A window that kept every output wrote 2-7 GB to disk a run; a
    file written over within seconds never leaves the page cache."""

    def __init__(self, seed: int, n_inputs: int):
        rng = np.random.default_rng([int(seed) % 2 ** 63, 11])
        self.n = n_inputs
        self.kept = [int(r) for r in rng.integers(0, KEEP_ROUNDS, n_inputs)]

    def tag(self, k: int) -> str:
        i = k % self.n
        return f"job{k}" if k // self.n == self.kept[i] else f"slot{i}"


def sample_indices(seed: int, first: int, draws: int) -> set:
    """Job indices whose outputs an in-memory driver keeps for the check,
    drawn from the seed among the first `first` jobs (the last job is
    kept besides)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    return set(int(v) for v in rng.integers(0, first, draws))
