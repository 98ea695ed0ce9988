"""Process-based input staging: file read (FLAC decode) + C++ wire encode
in a separate OS process, port of tomatis_tpu/engine/staging.py.

Why a process and not a thread: the staging work of a chunk (file decode +
wire encode) is supposed to hide behind the main thread's dispatch and
the writer thread's decode and encode. A thread shares the interpreter
lock with both; a separate process shares nothing.

The worker is a single persistent child (plain subprocess + pickle
streams over stdin/stdout, NOT multiprocessing spawn, which re-imports
the parent's __main__ and breaks for embedded/stdin entry points). It
imports only the torch-free host modules (io.audio, io.wirecodec,
utils.rolling), so its one-time startup is short, is paid once per parent
process, and never creates a CUDA context; its steady-state cost is one
pipe round per chunk (one memcpy of the encoded payload each way). This
module itself imports neither torch nor jax, and a test pins that.

Protocol (parent -> worker): one job dict per stream, then blocking
reads of ("item", kind, payload) messages in chunk order, terminated by
("done",) or ("error", msg). A stream abandoned mid-way (error on the
consumer side) is drained with a bounded timeout, after which the
worker is killed; the singleton respawns lazily, so correctness never
depends on worker state.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading

import numpy as np


def host_encode(sig: np.ndarray, int_in: bool, rice: bool):
    """Host half of input staging (no torch calls): wire-compress the
    chunk when it is PCM_24-exact. Int24 sources stay integer end to
    end; float sources that are not PCM_24-exact ship raw. Returns the
    tagged item streaming.stage_to_device takes. Shared by the thread
    producer (streaming.stage_encode) and the process worker below."""
    from tomatis_tpu_torch.io import wirecodec
    if int_in:
        return ("wire", wirecodec.encode_i32(sig, rice=rice))
    packed = wirecodec.encode_f32(sig, rice=rice)
    return ("raw_inexact", sig) if packed is None else ("wire", packed)


def _child_entry():
    """Worker loop (runs in the child): pickled jobs in on stdin,
    pickled messages out on stdout. One job at a time; per-stream
    exceptions are reported, the loop itself only exits on EOF."""
    out = sys.stdout.buffer
    sys.stdout = sys.stderr   # stray prints must not corrupt the pipe
    fin = sys.stdin.buffer

    def send(msg):
        pickle.dump(msg, out, protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()

    while True:
        try:
            job = pickle.load(fin)
        except (EOFError, OSError):
            return
        if job is None:
            return
        try:
            if isinstance(job, tuple):   # synchronous RPC (decode etc.)
                send(_serve_rpc(job))
            else:
                _run_stream(send, job)
                send(("done",))
        except Exception as e:  # noqa: BLE001 — forwarded to the parent
            try:
                send(("error", f"{type(e).__name__}: {e}"))
            except (OSError, ValueError):
                return


def _serve_rpc(req):
    from tomatis_tpu_torch.io import wirecodec
    if req[0] == "decode_pcm24":
        _, buf, n, ch = req
        arr = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) \
            else buf
        return ("ok", wirecodec.decode_pcm24(arr, n, ch))
    if req[0] == "encode_f32":
        _, sig, rice = req
        return ("ok", wirecodec.encode_f32(sig, rice=rice))
    if req[0] == "encode_i32":
        _, sig, rice = req
        return ("ok", wirecodec.encode_i32(sig, rice=rice))
    raise ValueError(f"unknown rpc {req[0]!r}")


def _run_stream(send, job):
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.utils.rolling import RollingReader

    with audio.AudioFile(job["path"], "r") as src:
        in_base = job["in_base"]
        if in_base > 0:
            src.seek(in_base)
        read = src.read_int24 if job["int_in"] else src.read
        reader = RollingReader(read, job["channels"],
                               dtype=np.int32 if job["int_in"]
                               else np.float32,
                               left_pad=max(0, -in_base), base=in_base,
                               block=job["block"])
        for win_start, win_len, adv in job["schedule"]:
            sig = reader.window(win_start, win_len)
            item = host_encode(sig, job["int_in"], job["rice"])
            if adv is not None:
                reader.advance(adv)
            send(("item",) + item)


_CHILD_CODE = ("import sys; "
               "from tomatis_tpu_torch.engine.staging import _child_entry; "
               "_child_entry()")


class _Worker:
    """One persistent child process + its pickle streams."""

    def __init__(self):
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_CODE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def send(self, obj):
        pickle.dump(obj, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def recv(self):
        return pickle.load(self.proc.stdout)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=5)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass
        for s in (self.proc.stdin, self.proc.stdout):
            try:
                s.close()
            except OSError:
                pass


_LOCK = threading.Lock()
_WORKER: list = []          # 0 or 1 persistent _Worker
_WORKER_BUSY: list = []     # the stream currently using the singleton


class StagedStream:
    """Parent-side handle of one in-flight staged stream. get() returns
    the next ("wire", bytes) / ("raw"/"raw_inexact", ndarray) item in
    chunk order; close() drains or destroys the worker so the next
    stream starts clean.

    One stream at a time rides the persistent singleton worker;
    concurrent streams (threaded callers) each get a dedicated
    throwaway worker so they can never cross pipes."""

    def __init__(self, job: dict):
        with _LOCK:
            if _WORKER_BUSY:
                self._w = _Worker()
                self._dedicated = True
            else:
                if _WORKER and not _WORKER[0].alive():
                    _WORKER[0].kill()
                    _WORKER.clear()
                if not _WORKER:
                    _WORKER.append(_Worker())
                self._w = _WORKER[0]
                self._dedicated = False
                _WORKER_BUSY.append(self)
        self._w.send(job)
        self._finished = False

    def _finish(self):
        self._finished = True
        with _LOCK:
            if self._dedicated:
                self._w.kill()
            elif self in _WORKER_BUSY:
                _WORKER_BUSY.remove(self)

    def get(self):
        try:
            msg = self._w.recv()
        except (EOFError, OSError, ValueError, pickle.UnpicklingError) as e:
            self._finish()
            raise RuntimeError(f"staging worker died: {e}") from e
        if msg[0] == "item":
            return msg[1:]
        self._finish()
        if msg[0] == "error":
            raise RuntimeError(f"staging worker: {msg[1]}")
        raise StopIteration

    def close(self):
        """Drain the remainder (bounded, on a helper thread — the pipe
        has no timed recv) so the worker is reusable; on timeout kill
        it — the singleton respawns lazily."""
        if self._finished:
            return
        if self._dedicated:   # throwaway worker: no need to drain
            self._finished = True
            self._w.kill()
            return
        done = []

        def _drain():
            try:
                while True:
                    msg = self._w.recv()
                    if msg[0] in ("done", "error"):
                        done.append(True)
                        return
            except (EOFError, OSError, ValueError,
                    pickle.UnpicklingError):
                return
        th = threading.Thread(target=_drain, daemon=True)
        th.start()
        th.join(10.0)
        if done:
            self._finish()
            return
        # still mid-stream (or broken pipe): destroy
        with _LOCK:
            self._w.kill()
            if _WORKER and _WORKER[0] is self._w:
                _WORKER.clear()
            if self in _WORKER_BUSY:
                _WORKER_BUSY.remove(self)
        self._finished = True


_RPC: list = []             # 0 or 1 persistent decode-RPC _Worker
_RPC_LOCK = threading.Lock()


def ensure_rpc_worker() -> None:
    """Start the decode-RPC worker if absent (non-blocking: Popen
    returns immediately and the child imports while the caller warms
    up). Call at stream start when the run is long enough to use it."""
    with _RPC_LOCK:
        if _RPC and not _RPC[0].alive():
            _RPC[0].kill()
            _RPC.clear()
        if not _RPC:
            try:
                _RPC.append(_Worker())
            except OSError:
                pass   # offload unavailable: callers decode locally


def rpc_available() -> bool:
    """True when the decode-RPC worker is up (callers may pick the
    offloaded decoder without paying a spawn)."""
    return bool(_RPC) and _RPC[0].alive()


def decode_pcm24_offload(buf: np.ndarray, n: int, ch: int) -> np.ndarray:
    """wirecodec.decode_pcm24 in the RPC worker process (so the decode
    of a chunk shares no interpreter lock with the dispatching thread).
    Falls back to the local decoder on ANY worker trouble —
    the offload is an optimization, never a failure source."""
    msg = _rpc_call(("decode_pcm24", buf, n, ch))
    if msg is not None:
        return msg[1]
    from tomatis_tpu_torch.io import wirecodec
    return wirecodec.decode_pcm24(buf, n, ch)


def _rpc_call(req):
    """One locked request/response against the RPC worker; None when the
    worker is down or errors (caller falls back to the local codec)."""
    with _RPC_LOCK:
        w = _RPC[0] if _RPC and _RPC[0].alive() else None
        if w is None:
            return None
        try:
            w.send(req)
            msg = w.recv()
            if msg[0] == "ok":
                return msg
        except (EOFError, OSError, ValueError, pickle.UnpicklingError):
            pass
        w.kill()
        _RPC.clear()
        return None


def host_encode_offload(sig: np.ndarray, int_in: bool, rice: bool):
    """staging.host_encode through the RPC worker (for stream loops that
    encode on their dispatching thread); local fallback on any worker
    trouble. Note encode_f32 may legitimately return None
    (non-PCM_24-exact floats): that is a result, not a failure."""
    op = "encode_i32" if int_in else "encode_f32"
    msg = _rpc_call((op, sig, rice))
    if msg is None:
        return host_encode(sig, int_in, rice)
    packed = msg[1]
    if int_in:
        return ("wire", packed)
    return ("raw_inexact", sig) if packed is None else ("wire", packed)


def stage_stream(path: str, int_in: bool, channels: int, in_base: int,
                 block: int, schedule: list, rice: bool) -> StagedStream:
    """Start staging `schedule` (list of (window_start, window_len,
    advance_or_None) in absolute sample coords) from `path` in the
    persistent worker process."""
    return StagedStream(dict(path=str(path), int_in=bool(int_in),
                             channels=int(channels), in_base=int(in_base),
                             block=int(block), schedule=list(schedule),
                             rice=bool(rice)))


def shutdown_workers() -> None:
    """Stop the persistent workers (they also exit on their own when the
    parent's pipes close); the next stream or RPC respawns them."""
    with _LOCK:
        for w in _WORKER:
            w.kill()
        _WORKER.clear()
        _WORKER_BUSY.clear()
    with _RPC_LOCK:
        for w in _RPC:
            w.kill()
        _RPC.clear()


def process_staging_enabled() -> bool:
    """Default ON; TOMATIS_PROCESS_STAGE=0 falls back to the in-process
    producer thread (useful for debugging and exotic platforms)."""
    return os.environ.get("TOMATIS_PROCESS_STAGE", "1") != "0"
