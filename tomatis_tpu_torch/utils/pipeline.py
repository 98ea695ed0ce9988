"""Host-side pipelining helpers for the streaming loops, port of
tomatis_tpu/utils/pipeline.py (torch-free: the device half of a stage
lives in the handle the caller pushes).

Three primitives shared by engine/streaming.py, models/eq.py and
parallel/batch.py:

- Prefetcher: runs a generator on a daemon thread with a bounded buffer
  (input staging: file read and FLAC decode overlap the device and the
  output side).
- OrderedWorker: a single background worker executing submitted jobs
  strictly in order (output side: drain + file write and FLAC encode
  overlap the next chunks).
- StagedPipeline: the depth-3 in-flight chunk stage machine the stream
  loops run their device round trips through.

Prefetcher and OrderedWorker preserve exception semantics: an error on
the helper thread is re-raised on the caller's thread, at its position
in the stream (Prefetcher.get) or at the next check/join
(OrderedWorker). Shutdown is prompt even when the hand-off queue is
full.
"""
from __future__ import annotations

import queue
import threading


class StagedPipeline:
    """Depth-3 software pipeline over in-flight device chunks.

    Every dispatched chunk advances through three stages, each getting a
    full loop iteration of slack before anything blocks on it:

      S1  wait for the chunk's compute, then start the readback:
          ``wait_arr.block_until_ready()`` (on the card a CUDA event wait)
          and ``wait_arr.copy_to_host_async()`` (a non-blocking copy into
          pinned memory). A ``wait_arr`` without those methods (a host
          array) passes through;
      S2  read the small readback and issue the fetch of a variable-size
          stream, such as the wire batch's (``start(chunk)`` -> opaque
          fetch state);
      S3  wait the copies out and hand the host half off
          (``finish(chunk)``).

    The caller owns the loop shape (and its timing accounting): per
    iteration, ``push`` the just-dispatched chunk, ``promote`` older
    chunks one stage each, then ``retire`` the chunk whose transfers have
    had a full iteration. ``drain`` runs everything left to completion in
    stream order — stage by stage, so all fetches are issued before
    any materialize blocks. Chunks are dicts with the caller's ``ready``
    payload plus ``wait_arr``/``started``/``stage`` bookkeeping.
    """

    def __init__(self, start, finish, depth: int = 3):
        self._start = start
        self._finish = finish
        self._depth = depth
        self.items: list = []

    def push(self, ready, wait_arr) -> None:
        self.items.append(dict(ready=ready, wait_arr=wait_arr,
                               started=None, stage=0))

    def _s1(self, ck) -> None:
        arr = ck["wait_arr"]
        if hasattr(arr, "block_until_ready"):
            arr.block_until_ready()
            arr.copy_to_host_async()
        ck["stage"] = 1

    def _s2(self, ck) -> None:
        ck["started"] = self._start(ck)
        ck["stage"] = 2

    def _s3(self, ck) -> None:
        self._finish(ck)
        ck["stage"] = 3

    def _advance(self, ck, to_stage: int) -> None:
        for s, fn in ((1, self._s1), (2, self._s2), (3, self._s3)):
            if s > to_stage:
                break
            if ck["stage"] < s:
                fn(ck)

    def promote(self) -> None:
        """Advance older chunks one stage each (oldest first, capped at
        S2 — S3 is the retire step)."""
        m = len(self.items) - 1
        for i, ck in enumerate(self.items[:-1]):
            self._advance(ck, min(2, m - i))

    def due(self) -> bool:
        """Whether retire() would finish a chunk now."""
        return len(self.items) > self._depth

    def retire(self) -> bool:
        """Finish the oldest chunk once it has had `depth` iterations of
        slack (advancing it through any stage it has not reached —
        with depth < 3 a chunk can retire before promote() got it to
        S2). Returns whether a chunk was retired."""
        if not self.due():
            return False
        ck = self.items.pop(0)
        self._advance(ck, 3)
        return True

    def drain(self) -> None:
        """Run every in-flight chunk to completion, in stream order."""
        for stage in (1, 2, 3):
            for ck in self.items:
                self._advance(ck, stage)
        del self.items[:]


class Prefetcher:
    """Iterate `gen` on a daemon thread, buffering up to `depth` items.
    name: the thread's (utils/trace.py's rows carry it)."""

    _DONE = object()

    def __init__(self, gen, depth: int = 2, name: str = "producer"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(gen,),
                                        name=name, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        # bounded put: a full queue with a caller that already errored
        # out must not hang this thread
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen):
        try:
            for item in gen:
                if not self._put(item):
                    return
        except BaseException as e:
            self._put(e)
            return
        self._put(self._DONE)

    def get(self):
        """Next item, in order. Re-raises the generator's exception at
        its stream position; raises StopIteration past the end. Both
        terminal states are sticky — a later get() raises again instead
        of blocking on the dead producer."""
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)
            raise StopIteration
        if isinstance(item, BaseException):
            self._q.put(item)
            raise item
        return item

    def close(self):
        """Stop the thread promptly (queue may still hold items)."""
        self._stop.set()
        self._thread.join(timeout=5.0)


class OrderedWorker:
    """Run submitted zero-arg callables on one thread, strictly in order.

    After a job raises, later jobs are skipped and the exception is
    re-raised on the caller's thread by check()/join(). name: the
    thread's.
    """

    def __init__(self, depth: int = 2, name: str = "writer"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._errs: list = []
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                if not self._errs:
                    job()
            except BaseException as e:
                self._errs.append(e)
            finally:
                self._q.task_done()

    def submit(self, job) -> None:
        """Enqueue a callable (blocks while `depth` jobs are pending),
        then surface any earlier job's exception."""
        self._q.put(job)
        self.check()

    def check(self, join: bool = False) -> None:
        """Re-raise the first failed job's exception, if any; with
        join=True, first wait for all submitted jobs to finish."""
        if join:
            self._q.join()
        if self._errs:
            raise self._errs[0]

    def close(self):
        """Finish remaining jobs and stop the thread."""
        self._q.put(None)
        self._thread.join(timeout=5.0)
