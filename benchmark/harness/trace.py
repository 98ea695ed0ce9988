"""The benchmark's own host spans, and the reading of a torch.profiler
(CUPTI) trace of the window: device busy time, device time by operation,
and the device's idle gaps named by the host span they fell in.

Spans are (name, start, end) on the host's perf_counter, from any thread.
Those of the calling thread are also torch.profiler record_function
ranges, so they show in an exported trace."""
from __future__ import annotations

import contextlib
import threading
import time


class Spans:
    def __init__(self, profile: bool = False):
        self.rows: list = []
        self._lock = threading.Lock()
        self._profile = profile

    @contextlib.contextmanager
    def span(self, name: str):
        main = threading.current_thread() is threading.main_thread()
        rf = None
        if self._profile and main:
            from torch.profiler import record_function
            rf = record_function(f"bench/{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self.rows.append((name, t0, t1))

    def wrap(self, name: str, fn):
        """fn with every call inside a span (for callbacks)."""
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped


class DeviceTrace:
    """torch.profiler over the window. After stop(): intervals (device
    operations, seconds on the host's perf_counter), by_name {name:
    [seconds, count]}, window_s."""

    ANCHOR = "bench/anchor"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.intervals: list = []
        self.by_name: dict = {}

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        with record_function(self.ANCHOR):
            self._anchor = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = _events(self._prof)
        anchor = next((e for e in events if e[0] == self.ANCHOR), None)
        if anchor is None:
            raise RuntimeError("the profiler lost the anchor span")
        offset = self._anchor - anchor[2]
        for name, on_device, a, b, annotation in events:
            # device work only: a record_function range also shows on the
            # device's timeline, as a user annotation
            if not on_device or annotation or name.startswith("bench/"):
                continue
            self.intervals.append((a + offset, b + offset))
            row = self.by_name.setdefault(name, [0.0, 0])
            row[0] += b - a
            row[1] += 1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device intervals inside the window, merged."""
        merged: list = []
        for a, b in sorted(self.intervals):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_gaps(self, spans: list, top: int = 10) -> list:
        """The device's idle time inside the window, summed by the
        innermost benchmark span that holds each gap's middle."""
        edges = [self.t0] + [x for ab in self.busy() for x in ab] + [self.t1]
        by: dict = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "outside any span")
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10, width: int = 160) -> list:
        """The device operations that took the most time, their names cut
        to `width` characters (C++ kernel names run to a kilobyte)."""
        return sorted(([k[:width], v[0]] for k, v in self.by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def seconds_of(self, match) -> tuple:
        """(seconds, count) of the device operations whose name
        match(name) accepts."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.by_name.items():
            if match(name):
                s += sec
                n += cnt
        return s, n


def _events(prof) -> list:
    """(name, on the device, start s, end s, user annotation) of every
    event of a stopped profile, from its raw Kineto results (building the
    profiler's FunctionEvent tree instead takes minutes for a window of
    tens of thousands of launches)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9,
             bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]
