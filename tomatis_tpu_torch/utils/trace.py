"""Program spans of the port: the one recorder behind the stream's and the
batch's stage timers, on every thread (torch-free at import, like
utils/pipeline.py).

A span times one piece of host work, per chunk, per flush or per lane
read (never per sample or per CSV row), on time.perf_counter(): the clock
that benchmark/harness/trace.py::DeviceTrace maps the device's events
onto, so a device gap can be put down to the program span that holds it.

- Always: a span adds its duration to acc[key] (a job's timings dict, or
  a lane's). These sums are the stats' stage timers; a span without acc
  times nothing.
- With the timeline on (TOMATIS_TRACE=1 in the environment, or inside
  timeline()): each span also appends a Row to a bounded in-memory buffer
  (rows(), clear()), and a span on the main thread opens a
  torch.profiler.record_function range of its name, so a profiler trace
  shows it. A span's parent is the span open around it on its thread; a
  span given no `at` takes its parent's.

Each StreamRunner.run and process_batch call takes a job id from
new_job(); it is in the stats ("job_id") and on every row of the call.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

MAX_ROWS = 200_000

Row = collections.namedtuple("Row", "name thread job at parent t0 t1")

_rows: collections.deque = collections.deque(maxlen=MAX_ROWS)
_jobs = itertools.count(1)
_local = threading.local()
_forced = [0]          # timeline() nesting depth


def enabled() -> bool:
    """Whether spans record rows and ranges (the accumulators always
    run)."""
    return bool(_forced[0]) or os.environ.get("TOMATIS_TRACE", "") not in (
        "", "0")


@contextlib.contextmanager
def timeline():
    """The timeline on inside the block, whatever TOMATIS_TRACE says."""
    _forced[0] += 1
    try:
        yield
    finally:
        _forced[0] -= 1


def new_job() -> int:
    """A process-wide id for one stream or batch call."""
    return next(_jobs)


def rows() -> list:
    """The rows recorded so far (the oldest dropped past MAX_ROWS)."""
    return list(_rows)


def clear() -> None:
    _rows.clear()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """with span(name, acc, key, job=..., at=...): time the block into
    acc[key]; with the timeline on, record it as a Row. at: the chunk's
    first frame or the lane."""

    __slots__ = ("name", "acc", "key", "job", "at", "t0", "_parent",
                 "_range")

    def __init__(self, name: str, acc: dict | None = None,
                 key: str | None = None, *, job: int = 0, at=None):
        self.name, self.acc, self.key = name, acc, key
        self.job, self.at = job, at
        self._parent = self._range = None

    def __enter__(self):
        if enabled():
            st = _stack()
            if st:
                self._parent = st[-1]
                if self.at is None:
                    self.at = self._parent.at
            st.append(self)
            if threading.current_thread() is threading.main_thread():
                from torch.profiler import record_function
                self._range = record_function(self.name)
                self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        acc = self.acc
        if acc is not None:
            acc[self.key] = acc.get(self.key, 0.0) + (t1 - self.t0)
        st = getattr(_local, "stack", None)
        if st and st[-1] is self:
            st.pop()
            if self._range is not None:
                self._range.__exit__(None, None, None)
            parent = self._parent
            _rows.append(Row(self.name, threading.current_thread().name,
                             self.job, self.at,
                             parent.name if parent is not None else None,
                             self.t0, t1))
        return False


ANCHOR = "tomatis/anchor"


def anchor() -> float:
    """Open and close a record_function range of ANCHOR under a running
    profiler; returns its perf_counter time, which puts the exported trace
    on this module's clock (add_to_chrome_trace)."""
    from torch.profiler import record_function
    with record_function(ANCHOR):
        return time.perf_counter()


def add_to_chrome_trace(path: str, anchor_t: float, job_rows: list) -> int:
    """Add rows to an exported torch.profiler chrome trace as one track
    per thread, aligned by the ANCHOR range recorded at perf_counter time
    anchor_t (the way DeviceTrace aligns the device's events). Returns
    the number of rows added; 0 when the trace holds no anchor."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    mark = next((e for e in events if e.get("name") == ANCHOR
                 and e.get("ph") == "X"
                 and not str(e.get("cat", "")).startswith("gpu")), None)
    if mark is None or not job_rows:
        return 0
    base_us = float(mark["ts"]) - anchor_t * 1e6
    pid = os.getpid()
    tids = {}
    for r in job_rows:
        if r.thread not in tids:
            tid = tids[r.thread] = 1_000_000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"program: {r.thread}"}})
        events.append({"ph": "X", "cat": "program_span", "name": r.name,
                       "pid": pid, "tid": tids[r.thread],
                       "ts": base_us + r.t0 * 1e6,
                       "dur": (r.t1 - r.t0) * 1e6,
                       "args": {"job": r.job, "at": r.at,
                                "parent": r.parent}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(job_rows)
