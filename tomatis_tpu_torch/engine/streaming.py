"""Chunked streaming STFT+OLA executor, PyTorch port of
tomatis_tpu/engine/streaming.py.

- A fixed-shape chunk of ``frames_per_chunk`` frames is processed by one
  chunk step on the device: frame levels -> controller (gate, gain rows)
  -> batched rFFT gain bank -> the chunk tail, one launch of the fused
  CUDA kernel of ops/cuda_ola.py: window, mask, K-way overlap-add of the
  frames and of the window-square normaliser, add the carried tails,
  normalise, (pcm24) output gain, per-hop-block peaks and PCM_24
  quantise.
- Sequential state crosses chunk boundaries as a small carry: controller
  carry, OLA sample tail, OLA window-sum tail.
- The host driver keeps the reference's absolute-coordinate write-out:
  half-window start pad, computed end pad, a flush every >= 5 s of safe
  samples with per-flush peak clamping to 0.999, via an explicit flush
  plan (flush boundaries change the audible output).

The stream loop is the reference's: a producer thread reads the file;
the calling thread uploads, enqueues the chunk step and moves every chunk
through the depth-3 pipeline of utils/pipeline.py (S1 a CUDA event wait
and a non-blocking readback into pinned memory, S3 the hand-over); an
ordered writer thread routes, drains the flush cuts and calls the sinks.
All enqueueing stays on the calling thread (torch's current stream and
device are thread-local). What the threads hide on a PCIe-attached card
is not a link but the host codecs: the input file's decode and the
output file's encode overlap each other and the device.
Checkpoint/resume (engine/checkpoint.py) snapshots the stream state
between chunks, under the reference's .npz key names, with the pipeline
drained first.

Transports: "f32" reads floats back, "pcm24" PCM_24 bytes quantised on
the device; both write the same file to <= 1 LSB. The reference's third,
"wire" (the link compressed both ways), is not carried over for one
file: on an H100 host it wrote pcm24's bytes 11-28% slower. It lives on
in parallel/batch.py, which picks it from the measured link.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tomatis_tpu_torch.ops import cuda_ola, stft
from tomatis_tpu_torch.ops.dsp import EPS, PEAK_LIMIT, frame_levels_dbfs
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.utils.pcm import le24_from_i32
from tomatis_tpu_torch.utils.pipeline import (OrderedWorker, Prefetcher,
                                              StagedPipeline)
from tomatis_tpu_torch.utils.rolling import RollingReader

FLUSH_THRESHOLD = 48000 * 5  # hard-coded in the reference (src/process_tomatis.py:420)

def ramp_disabled() -> bool:
    """True when TOMATIS_NO_RAMP disables the chunk ramp-up schedule.
    The schedule decides chunk boundaries and therefore the output's float
    summation order; the port keeps the reference's switch so both cut a
    stream into the same chunks."""
    return bool(os.environ.get("TOMATIS_NO_RAMP"))


def resolve_transport(transport: str, supports_raw: bool):
    """Resolve a user-facing transport against the sink.

    transport: "auto" | "pcm24" | "f32". Returns (resolved transport,
    byte_payload), byte_payload saying that the sink receives raw PCM_24
    bytes (write_raw) rather than float samples. On the port "auto" picks
    pcm24 on a raw-capable sink (the reference's advice for
    PCIe-attached hosts, where the link is free and host cores are
    scarce), f32 otherwise. A byte transport on a sink that cannot take
    raw PCM_24 is an error, not a silent downgrade."""
    if transport not in ("auto", "pcm24", "f32"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "auto":
        transport = "pcm24" if supports_raw else "f32"
    elif transport == "pcm24" and not supports_raw:
        raise ValueError(f"transport {transport!r} requires a sink that "
                         "accepts raw PCM_24 bytes")
    return transport, transport == "pcm24"


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. On a card: through pinned memory
    with a non-blocking copy (the caching host allocator keeps the pinned
    block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


def stage_to_device(sig: np.ndarray, device="cuda") -> torch.Tensor:
    """Device half of input staging (call from the dispatching thread:
    every enqueue stays on one thread): upload the chunk's window; a
    window of PCM_24 ints (an int24 read) is scaled there, v / 2^23, as
    the file readers scale it. Returns the chunk's float32 [n, ch]
    tensor."""
    t = _upload(sig, torch.device(device))
    if t.dtype == torch.int32:
        t = t.to(torch.float32) / 8388608.0
    return t


# ---------------------------------------------------------------------------
# Flush plan: where the reference's streaming write-out cuts its chunks.
# ---------------------------------------------------------------------------

@dataclass
class FlushPlan:
    """Write-out chunk boundaries in absolute sample coordinates.

    ``cuts`` are (abs_start, length) pairs covering [-pad, end)
    contiguously; peak clamping applies per cut after clipping to
    [0, total)."""
    cuts: list
    pad: int
    pad_end: int
    n_frames: int
    total: int


def flush_plan(total: int, n_fft: int, hop: int,
               threshold: int = FLUSH_THRESHOLD) -> FlushPlan:
    if (n_fft // 2) % hop:
        # frames start at -n_fft//2; if hop does not divide the pad, the
        # reference's pad_end formula leaves the stream tail uncovered
        raise ValueError(
            "n_fft//2 must be a multiple of hop for the cropped streaming "
            "write-out")
    pad = n_fft // 2
    pad_end = stft.pad_end(total, n_fft, hop)
    n_frames = (pad + total + pad_end - n_fft) // hop + 1
    if n_frames <= 0:
        return FlushPlan([], pad, pad_end, 0, total)
    cuts = []
    out_base = -pad
    for j in range(n_frames):
        next_start = -pad + (j + 1) * hop
        safe = next_start - out_base - n_fft
        if safe >= threshold:
            cuts.append((out_base, safe))
            out_base += safe
    end = -pad + (n_frames - 1) * hop + n_fft
    if end > out_base:
        cuts.append((out_base, end - out_base))
    return FlushPlan(cuts, pad, pad_end, n_frames, total)


# ---------------------------------------------------------------------------
# The device chunk step.
# ---------------------------------------------------------------------------

class ChunkedStftEngine:
    """Runs the per-chunk pipeline for one (n_fft, hop, C, F_c) on a device."""

    def __init__(self, n_fft: int, hop: int, channels: int = 2,
                 frames_per_chunk: int = 1024,
                 window: np.ndarray | None = None, device="cuda"):
        if n_fft % hop:
            raise ValueError("n_fft must be a multiple of hop")
        self.n_fft = n_fft
        self.hop = hop
        self.channels = channels
        self.frames_per_chunk = frames_per_chunk
        self.device = torch.device(device)
        self.window = (stft.hann_symmetric(n_fft) if window is None
                       else np.asarray(window, np.float32))
        self.tail_len = n_fft - hop
        self.chunk_input_len = (frames_per_chunk - 1) * hop + n_fft
        self.emit_len = frames_per_chunk * hop
        self.emit_full = self.emit_len + self.tail_len
        self.aux_width = frames_per_chunk + n_fft // hop - 1
        self.log_keys: tuple = ()
        self._log_keys_bound = False

    def zero_tails(self):
        return (torch.zeros((self.tail_len, self.channels),
                            dtype=torch.float32, device=self.device),
                torch.zeros((self.tail_len,), dtype=torch.float32,
                            device=self.device))

    def make_chunk_fn(self, controller, transport: str = "f32",
                      norm: str = "eps") -> Callable:
        """Build the chunk step
        fn(sig [L, C], n_valid, ctl_carry, out_tail, w_tail, params,
           gain_lin) -> (payload, aux, out, ctl_carry', out_tail', w_tail').

        controller provides LOG_KEYS, params(), init_carry() and
        step(levels [F], valid [F] bool, carry, params) ->
            (gains [F, bins] float32 linear, log dict of [F], carry').

        aux [R, W] (W = F + n_fft/hop - 1) float32 rows: levels, one row per
        LOG_KEYS entry and (pcm24 only) the per-hop-block max |emit*gain|.

        transport="f32": payload is the normalised emit [F*hop + tail, C];
            the host applies the output gain (like the reference's
            write_clamped); out is None.
        transport="pcm24": payload is the flat little-endian PCM_24 bytes
            of clip(round(emit*gain_lin * 2^23)), half to even; out is the
            pre-quantisation float tensor, left on the device for the rare
            clamped flush (ints saturate at full scale, so a clamp cannot
            be recovered from the bytes).

        norm: "eps" y/(w + 1e-12), the streaming processors' convention;
        "floor8" y/max(w, 1e-8), the adaptive processor's.
        """
        if transport not in ("f32", "pcm24"):
            raise ValueError(f"unknown transport {transport!r}")
        if norm not in ("eps", "floor8"):
            raise ValueError(norm)
        log_keys = self._bind_log_keys(controller)
        self.transport = transport
        n_fft, hop, F = self.n_fft, self.hop, self.frames_per_chunk
        dev = self.device
        win = torch.as_tensor(self.window, device=dev)
        win2 = win * win
        W = self.aux_width
        frame_idx = torch.arange(F, device=dev)

        def chunk_fn(sig, n_valid: int, ctl_carry, out_tail, w_tail, params,
                     gain_lin):
            frames = stft.frame_signal(sig, n_fft, hop, F)      # [F, C, n_fft]
            levels = frame_levels_dbfs(frames.permute(0, 2, 1))  # [F]
            valid = frame_idx < n_valid
            gains, log, ctl_carry_new = controller.step(levels, valid,
                                                        ctl_carry, params)
            z = stft.gain_bank_irfft(frames, win, gains)
            # the fused kernel for a CUDA tensor, its plain version for a
            # CPU one (the engine's n_fft % hop check makes the K-way form
            # always apply)
            chunk_tail = (cuda_ola.chunk_tail_cuda if z.is_cuda
                          else cuda_ola.chunk_tail_plain)
            # Window, mask, overlap-add, add the carried tails and normalise
            # the whole span [F*hop + tail, C]. For a full chunk the host
            # uses only the first F*hop samples (the tail still awaits the
            # next chunk's frames, carried raw); for the stream's final,
            # possibly partial chunk the tail is complete here.
            out, peaks, pcm, ola_t, w_t = chunk_tail(
                z, win, win2, n_valid, out_tail, w_tail, gain_lin,
                norm=norm, transport=transport)
            rows = [levels] + [log[k] for k in log_keys]
            rows = [torch.nn.functional.pad(r.to(torch.float32), (0, W - F))
                    for r in rows]
            # an all-invalid chunk freezes every carry: it must not wipe the
            # OLA tail or advance the controller
            if n_valid > 0:
                carries = (ctl_carry_new, ola_t, w_t)
            else:
                carries = (ctl_carry, out_tail, w_tail)
            if transport == "f32":
                return (out, torch.stack(rows), None) + carries
            return (pcm, torch.stack(rows + [peaks]), out) + carries

        return chunk_fn

    def _bind_log_keys(self, controller) -> tuple:
        """Bind the aux rows' layout to the controller's LOG_KEYS. Rebinding
        one engine to controllers with different log rows would silently
        misalign it: one engine per controller type."""
        log_keys = tuple(getattr(controller, "LOG_KEYS", ()))
        if self._log_keys_bound and self.log_keys != log_keys:
            raise ValueError(
                f"engine already bound to LOG_KEYS {self.log_keys}; "
                f"controller wants {log_keys} — use a separate "
                "ChunkedStftEngine per controller type")
        self._log_keys_bound = True
        self.log_keys = log_keys
        return log_keys

    def make_batch_chunk_fn(self, controller) -> Callable:
        """The chunk step of B file lanes (parallel/batch.py), the
        counterpart of the reference's jax.vmap of make_chunk_fn over lanes
        (tomatis_tpu/parallel/batch.py:272):
        fn(sig [B, L, C], n_valid int32 [B], ctl_carries (a list of B
        carries), out_tail [B, tail, C], w_tail [B, tail], params,
        gain_lin) -> (pcm [B, emit_full*C*3] uint8, aux [B, R, W],
        out [B, emit_full, C], ctl_carries', out_tail', w_tail').

        Framing, levels, the controller and the rFFT gain bank run lane by
        lane at the single-file shapes, so each lane's arithmetic (cuFFT's
        plan included) is its single-file run's; then ONE launch of the
        batched chunk tail serves every lane. A lane with n_valid == 0
        freezes every carry: the kernel writes its tails back, and its
        controller carry is kept by torch.where on n_valid > 0 (no host
        sync). The step is pcm24's: payload, aux and out as make_chunk_fn's
        with transport="pcm24", one lane per row."""
        log_keys = self._bind_log_keys(controller)
        n_fft, hop, F = self.n_fft, self.hop, self.frames_per_chunk
        C, W, dev = self.channels, self.aux_width, self.device
        win = torch.as_tensor(self.window, device=dev)
        win2 = win * win
        frame_idx = torch.arange(F, device=dev)

        def chunk_fn(sig, n_valid, ctl_carries, out_tail, w_tail, params,
                     gain_lin):
            B = sig.shape[0]
            keep = n_valid > 0
            z = torch.empty((B, F, C, n_fft), dtype=torch.float32,
                            device=sig.device)
            aux_rows, carries = [], []
            for b in range(B):
                frames = stft.frame_signal(sig[b], n_fft, hop, F)
                levels = frame_levels_dbfs(frames.permute(0, 2, 1))
                gains, log, c_new = controller.step(
                    levels, frame_idx < n_valid[b], ctl_carries[b], params)
                z[b] = stft.gain_bank_irfft(frames, win, gains)
                rows = [levels] + [log[k] for k in log_keys]
                aux_rows.append(torch.stack([
                    torch.nn.functional.pad(r.to(torch.float32), (0, W - F))
                    for r in rows]))
                carries.append(_carry_like(c_new, [
                    torch.where(keep[b], new, old) for new, old in zip(
                        _carry_leaves(c_new), _carry_leaves(ctl_carries[b]))]))
            chunk_tail = (cuda_ola.chunk_tail_batched_cuda if z.is_cuda
                          else cuda_ola.chunk_tail_batched_plain)
            out, peaks, pcm, ola_t, w_t = chunk_tail(
                z, win, win2, n_valid, out_tail, w_tail, gain_lin,
                transport="pcm24")
            aux = torch.cat([torch.stack(aux_rows), peaks[:, None, :]], 1)
            return pcm, aux, out, carries, ola_t, w_t

        return chunk_fn


# ---------------------------------------------------------------------------
# Host-side stream driver.
# ---------------------------------------------------------------------------

def _read_fn(source):
    """read(n) callable over an AudioFile reader or an ndarray."""
    if isinstance(source, np.ndarray):
        x = source if source.ndim == 2 else source[:, None]
        cur = [0]

        def read(n):
            blk = x[cur[0]:cur[0] + n]
            cur[0] += len(blk)
            return blk
        return read
    return source.read


def timed_read(read, acc: dict, job: int = 0, at=None):
    """read(n) with every call a producer.decode span (a file's decode
    and its int or float conversion), its time into acc["decode_s"]."""
    def decode(n):
        with trace.span("producer.decode", acc, "decode_s", job=job, at=at):
            return read(n)
    return decode


def timed_sink(write, acc: dict, job: int = 0, at=None):
    """The audio sink with every call a writer.encode span (for a FLAC
    file: write_raw's le24 unpack and the native encode), its time into
    acc["encode_s"]."""
    def encode(chunk):
        with trace.span("writer.encode", acc, "encode_s", job=job, at=at):
            write(chunk)
    return encode


def _host(t) -> np.ndarray:
    """Device tensor (or host array) -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _carry_leaves(carry) -> list:
    """A controller carry (a tensor, or a tuple of carries) -> its tensors
    in order."""
    if isinstance(carry, (tuple, list)):
        return [leaf for c in carry for leaf in _carry_leaves(c)]
    return [carry]


def _carry_like(carry, leaves: list):
    """Rebuild a carry of `carry`'s structure from `leaves` (consumed from
    the front)."""
    if isinstance(carry, (tuple, list)):
        return tuple(_carry_like(c, leaves) for c in carry)
    return leaves.pop(0)


def _joined(pieces: list, empty_dtype) -> np.ndarray:
    """Pending pieces as one array (an empty one of empty_dtype for none)."""
    if not pieces:
        return np.zeros(0, empty_dtype)
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)


class ChunkReadback:
    """The device->host transfers of one dispatched chunk, in the three
    stages of utils.pipeline.StagedPipeline.

    On a card every copy is non-blocking into pinned memory of the
    chunk's own (a pinned buffer lives as long as the host arrays made
    from it, so the writer thread never reads one that is being
    refilled), and the device tensors stay referenced here until the
    hand-over. On a CPU device there is no pinned memory and no event:
    the tensors are the host arrays. The choice follows the tensors'
    device, never a caught error.

    fetch: the tensors read back in S1. stream: None, or (data, used) for
    a prefix of `data` whose length is only known on the device: `used`
    rides S1, and S2 fetches data[:used] once it is known (the wire batch
    of parallel/batch.py reads its compressed output so)."""

    def __init__(self, fetch: list, stream=None):
        self._fetch = list(fetch)
        self._stream = stream
        if stream is not None:
            self._fetch.append(stream[1])
        self._cuda = self._fetch[0].is_cuda
        self._host: list = []
        self._event = None
        if self._cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        if not self._cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _mark(self) -> None:
        if self._cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def _wait(self) -> None:
        if self._cuda:
            self._event.synchronize()

    def block_until_ready(self) -> None:
        """S1: wait for the chunk step (an event recorded behind it)."""
        self._wait()

    def copy_to_host_async(self) -> None:
        """S1: start the readback of the fetch list."""
        self._host = [self._copy(t) for t in self._fetch]
        self._mark()

    def start_stream(self) -> None:
        """S2: read `used` from the S1 readback and start the fetch of
        stream[0][:used]; a no-op without a stream."""
        if self._stream is None:
            return
        self._wait()
        used = int(self._host.pop())
        self._host.append(self._copy(self._stream[0][:used]))
        self._mark()

    def materialize(self) -> list:
        """S3: wait the copies out; the host arrays in fetch order (the
        stream's prefix last)."""
        self._wait()
        self._fetch, self._stream = [], None
        return [h.numpy() for h in self._host]


class StreamRunner:
    """Runs a controller over an audio stream with reference write semantics.

    The caller supplies sinks, called in stream order from a background
    worker thread (keep them thread-compatible: file and CSV writers are;
    the closing flush after a final full chunk runs on the calling
    thread, once the worker has stopped); a sink exception fails the run:
        on_frames(frame_idx0, starts, log)   per engine chunk (host arrays)
        on_audio(chunk)                      clamped output in file order:
                                             float [n, C] (f32) or PCM_24
                                             bytes (pcm24)
    """

    def __init__(self, engine: ChunkedStftEngine, controller, total: int,
                 output_gain_db: float = 0.0, transport: str = "f32",
                 build_chunk_fn: bool = True):
        """transport="pcm24" quantises and packs PCM_24 bytes on the device;
        the per-flush clamp decision then uses device-computed per-hop-block
        peaks, and the (rare) clamped flush rescales the pre-quantisation
        floats and re-encodes on the host: <= 1 LSB from the f32 path.

        build_chunk_fn=False: the runner carries the flush plan, total and
        output gain of one lane of parallel/batch.py and builds no chunk
        step (so no ramp) and cannot run()."""
        self.engine = engine
        self.controller = controller
        self.total = int(total)
        self.output_gain = float(10.0 ** (output_gain_db / 20.0)) \
            if output_gain_db else 1.0
        self.plan = flush_plan(total, engine.n_fft, engine.hop)
        self.transport = transport
        self.chunk_fn = (engine.make_chunk_fn(controller, transport=transport)
                         if build_chunk_fn else None)
        # Ramp-up schedule (F/4, F/2, then F): it fills the pipeline
        # sooner, and it is kept from the reference so that a stream is cut
        # into the same chunks, and so sums in the same order, on both
        # packages.
        F_c = engine.frames_per_chunk
        self._by_F = {F_c: (engine, self.chunk_fn)}
        self._ramp = bool(build_chunk_fn and self.plan.n_frames > 2 * F_c
                          and F_c % 4 == 0 and F_c // 4 >= 64
                          and not ramp_disabled())
        if self._ramp:
            for f in (F_c // 4, F_c // 2):
                e = ChunkedStftEngine(engine.n_fft, engine.hop,
                                      engine.channels, f,
                                      window=engine.window,
                                      device=engine.device)
                self._by_F[f] = (e, e.make_chunk_fn(controller,
                                                    transport=transport))
        self.ctl_params = controller.params()
        self.gain_f32 = torch.tensor(self.output_gain, dtype=torch.float32,
                                     device=engine.device)
        self.stats = {}
        self.audio_samples_written = 0

    def _chunk_F(self, frame0: int) -> int:
        """Frame count of the chunk starting at absolute frame `frame0` (a
        pure function of frame0, as in the reference)."""
        F_c = self.engine.frames_per_chunk
        if not self._ramp:
            return F_c
        if frame0 == 0:
            return F_c // 4
        if frame0 == F_c // 4:
            return F_c // 2
        return F_c

    def run(self, source, on_audio: Callable | None = None,
            on_frames: Callable | None = None, ckpt=None,
            resume_state: dict | None = None,
            on_progress: Callable | None = None,
            job: int | None = None) -> dict:
        """ckpt: optional engine.checkpoint.CheckpointManager; the stream
        state is saved before the dispatch of every ckpt.every-th chunk.
        resume_state: a state dict previously returned by ckpt.load(); the
        caller must position its sinks at the offsets in
        resume_state["__meta__"]["scalars"] (audio_samples_written,
        frames_consumed) before calling.

        The sinks (on_audio, on_frames, on_progress) are invoked in stream
        order but from a background worker thread. A sink exception fails
        the run.

        job: the utils.trace job id the run's spans carry (a new one when
        None); stats["job_id"] holds it."""
        job = trace.new_job() if job is None else job
        eng, plan = self.engine, self.plan
        hop, C = eng.hop, eng.channels
        pad, n_frames = plan.pad, plan.n_frames
        dev = eng.device

        if self.total <= 0 or n_frames <= 0:
            self.stats = dict(n_frames=0, c1_frames=0, c2_frames=0,
                              c1_ratio=0.0, c2_ratio=0.0, chunks=0,
                              timings={}, job_id=job)
            return self.stats

        # Host wall time per stage, each key the total of the
        # utils.trace spans of its name. Calling thread: stream.setup
        # (carries, tails, resume, reader, helper threads; the caller adds
        # the runner's construction), stream.input (stream.producer_wait
        # and stream.upload),
        # stream.dispatch (stream.step: the chunk step's enqueue;
        # stream.promote: S1), stream.consume (the S3 waits:
        # stream.readback; the writer's back-pressure and joins:
        # stream.backpressure) and stream.final_drain (the stream tail and
        # the last flush cut). Producer thread: producer.decode (the
        # source's reads). Writer thread: writer.job (a chunk's whole host
        # half), writer.csv (on_frames; a row only) and writer.encode
        # (on_audio, on the calling thread too for the last flush cut).
        timings = dict.fromkeys(
            ("runner_setup_s", "input_host_s", "producer_wait_s",
             "dispatch_compute_s", "consume_s", "final_drain_s",
             "decode_s", "writer_busy_s", "encode_s"), 0.0)

        def span(name, key=None, at=None):
            return trace.span(name, timings if key else None, key, job=job,
                              at=at)

        byte_payload = self.transport == "pcm24"
        sink = SinkState(pad)
        self.audio_samples_written = 0
        frame0 = 0
        write = (timed_sink(on_audio, timings, job)
                 if on_audio is not None else None)
        rows_out = None
        if on_frames is not None:
            def rows_out(f0, starts, log):
                with span("writer.csv"):
                    on_frames(f0, starts, log)

        with span("stream.setup", "runner_setup_s"):
            ctl_carry = self.controller.init_carry()
            out_tail, w_tail = eng.zero_tails()
            if resume_state is not None:
                sc = resume_state["__meta__"]["scalars"]
                frame0 = int(sc["frame0"])
                sink.out_base = int(sc["out_base"])
                sink.cut_i = int(sc["cut_i"])
                self.audio_samples_written = int(sc["audio_samples_written"])
                sink.states_count = resume_state["states_count"].copy()
                leaves = [torch.as_tensor(resume_state[f"carry{i}"],
                                          device=dev)
                          for i in range(int(sc["n_carry_leaves"]))]
                ctl_carry = _carry_like(ctl_carry, leaves)
                out_tail = torch.as_tensor(resume_state["out_tail"],
                                           device=dev)
                w_tail = torch.as_tensor(resume_state["w_tail"], device=dev)
                if resume_state["out_pend"].size:
                    sink.out_pend = [resume_state["out_pend"]]
                if resume_state["peak_pend"].size:
                    sink.peak_pend = [resume_state["peak_pend"]]
                fr = resume_state.get("ref_floats")
                if fr is not None and fr.size:
                    # the pre-quantisation floats of the pending samples,
                    # held on the host from here on (_gather_floats takes
                    # both)
                    sink.float_refs = [(sink.out_base, len(fr), fr)]

            # rolling input in absolute sample coordinates (the stream
            # starts at -pad); a resumed run seeks the source to its first
            # chunk
            in_base = -pad + frame0 * hop
            if in_base > 0:
                if isinstance(source, np.ndarray):
                    source = source[in_base:]
                else:
                    source.seek(in_base)
            reader = RollingReader(
                timed_read(_read_fn(source), timings, job), C,
                left_pad=max(0, -in_base), base=in_base,
                block=eng.emit_len)

        def consume_host(ready, mat):
            """Writer-thread half: route the payload via the shared
            SinkState."""
            c_frame0, c_nf, _rb, c_out_dev, c_eng = ready
            payload, aux = mat
            sink.route(self, c_eng, c_frame0, c_nf, payload, aux,
                       c_out_dev, rows_out, write, byte_payload)

        def save_checkpoint():
            """The state before the dispatch of the chunk at frame0, as
            host copies. The caller has drained the pipeline and joined
            the writer, so every earlier chunk is routed and written."""
            buf = _joined(sink.out_pend,
                          np.uint8 if byte_payload else np.float32)
            n_pend = len(buf) // (C * 3 if byte_payload else 1)
            refs = (self._gather_floats(sink.float_refs, sink.out_base,
                                        sink.out_base + n_pend, C)
                    if byte_payload and n_pend
                    else np.zeros((0, C), np.float32))
            leaves = [_host(leaf) for leaf in _carry_leaves(ctl_carry)]
            state = {f"carry{i}": leaf for i, leaf in enumerate(leaves)}
            state.update(out_tail=_host(out_tail), w_tail=_host(w_tail),
                         out_pend=buf,
                         peak_pend=_joined(sink.peak_pend, np.float32),
                         ref_floats=refs, states_count=sink.states_count)
            state["__scalars__"] = dict(
                frame0=int(frame0), out_base=int(sink.out_base),
                cut_i=int(sink.cut_i), n_carry_leaves=len(leaves),
                audio_samples_written=int(self.audio_samples_written),
                frames_consumed=int(frame0))
            ckpt.maybe_save(state, force=True)

        # Producer: the file read (a FLAC decode) of chunk k+1 runs while
        # chunk k is uploaded and dispatched. Exceptions surface on this
        # thread at the next get. Writer: once this thread has waited a
        # chunk's readback out, the host-only half (CSV rows, flush-cut
        # drain, file write with its FLAC encode) runs on the ordered
        # worker, so on_frames/on_audio/on_progress run there. Jobs run
        # strictly in order; the checkpoint and final-flush paths join the
        # queue first, so everything they read is fully drained. Both are
        # made inside the try whose finally closes them.
        def produce(f0):
            # chunk sizes must track the main loop exactly; _chunk_F is a
            # pure function of the frame cursor, so both sides agree
            while f0 < n_frames:
                e_i = self._by_F[self._chunk_F(f0)][0]
                sig = reader.window(-pad + f0 * hop, e_i.chunk_input_len)
                f0 += min(e_i.frames_per_chunk, n_frames - f0)
                if f0 < n_frames:
                    reader.advance(-pad + f0 * hop)
                yield sig

        def next_staged(at):
            with span("stream.input", "input_host_s", at):
                with span("stream.producer_wait", "producer_wait_s"):
                    sig = prefetch.get()
                with span("stream.upload"):
                    return stage_to_device(sig, dev)

        # Software pipeline, depth 3. Per iteration k:
        #   dispatch chunk k                (async; input staged last iter)
        #   S1 on chunk k-1: wait its compute, start the readback
        #   stage input k+1                 (producer wait + upload)
        #   S3 on chunk k-3: wait the copies (long since done), hand the
        #                    host half to the ordered writer thread
        # S2 has nothing to fetch: the readback is whole after S1.
        chunks = 0
        staged = None

        def pipe_finish(ck):
            at = ck["ready"][0]
            with span("stream.readback", at=at):
                mat = ck["ready"][2].materialize()

            def host_half(iv=ck["ready"], m=mat):
                with span("writer.job", "writer_busy_s", iv[0]):
                    consume_host(iv, m)
                    if on_progress is not None:
                        # frames fully processed and written so far
                        on_progress(iv[0] + iv[1], n_frames)
            with span("stream.backpressure", at=at):
                writer.submit(host_half)

        def drain_all():
            pipe.drain()
            with span("stream.backpressure"):
                writer.check(join=True)

        pipe = StagedPipeline(lambda ck: None, pipe_finish)

        last_full = False
        writer = prefetch = None
        try:
            with span("stream.setup", "runner_setup_s"):
                writer = OrderedWorker()
                prefetch = Prefetcher(produce(frame0))
            while frame0 < n_frames:
                eng_i, fn_i = self._by_F[self._chunk_F(frame0)]
                nf = min(eng_i.frames_per_chunk, n_frames - frame0)
                last_full = nf == eng_i.frames_per_chunk
                if ckpt is not None and chunks > 0 \
                        and chunks % ckpt.every == 0:
                    # checkpoint boundary: everything before this chunk
                    # must be consumed and drained before its state is
                    # captured, so the pipeline stalls here (checkpoints
                    # are many chunks apart)
                    with span("stream.consume", "consume_s", frame0):
                        drain_all()
                    save_checkpoint()
                chunks += 1
                if staged is None:
                    staged = next_staged(frame0)

                with span("stream.dispatch", "dispatch_compute_s", frame0):
                    with span("stream.step"):
                        (payload, aux, out_dev, ctl_carry, out_tail,
                         w_tail) = fn_i(staged, nf, ctl_carry, out_tail,
                                        w_tail, self.ctl_params,
                                        self.gain_f32)
                        rb = ChunkReadback([payload, aux])
                    pipe.push((frame0, nf, rb, out_dev, eng_i), rb)
                    # promote older chunks one pipeline stage each (oldest
                    # first, capped at S2; S3 is the retire step below)
                    with span("stream.promote"):
                        pipe.promote()
                frame0 += nf

                # stage the next chunk's input while the device works
                staged = None
                if frame0 < n_frames:
                    staged = next_staged(frame0)

                # retire the chunk whose readback has had a full iteration
                if pipe.due():
                    with span("stream.consume", "consume_s"):
                        pipe.retire()
            with span("stream.consume", "consume_s"):
                drain_all()
        finally:
            # stop a producer that is still blocked on a full queue (an
            # exception above leaves un-got items) and shut the writer
            # down; harmless after a normal exit where both are idle
            if prefetch is not None:
                prefetch.close()
            if writer is not None:
                writer.close()
        # if the last chunk was full, the stream's tail is still in the
        # carry (a checkpoint is always taken before a chunk's dispatch, so
        # a resumed run re-enters the loop and derives last_full again)
        with span("stream.final_drain", "final_drain_s"):
            if last_full:
                sink.append_tail(self, eng, n_frames, out_tail, w_tail,
                                 byte_payload)
            sink.final_drain(self, write)

        sc_ = sink.states_count
        total_f = int(sc_[1] + sc_[2])
        self.stats = dict(
            n_frames=n_frames,
            c1_frames=int(sc_[1]),
            c2_frames=int(sc_[2]),
            c1_ratio=sc_[1] / total_f if total_f else 0.0,
            c2_ratio=sc_[2] / total_f if total_f else 0.0,
            chunks=chunks,
            timings={k: round(v, 4) for k, v in timings.items()},
            job_id=job,
        )
        return self.stats

    def _drain(self, out_pend, peak_pend, float_refs, cut_i, out_base,
               final: bool, on_audio):
        """Write out every flush cut whose samples are fully available.
        Mutates the pending lists in place; returns (cut_i, out_base)."""
        plan = self.plan
        pcm24 = self.transport == "pcm24"
        unit = self.engine.channels * 3 if pcm24 else 1
        hop = self.engine.hop
        while cut_i < len(plan.cuts):
            start, n = plan.cuts[cut_i]
            avail = sum(len(a) for a in out_pend) // unit
            if not final and avail < (start - out_base) + n:
                break
            buf = _joined(out_pend, np.uint8 if pcm24 else np.float32)
            rel = start - out_base
            chunk = buf[rel * unit:(rel + n) * unit]
            if pcm24:
                pk = _joined(peak_pend, np.float32)
                self._write_cut_pcm24(chunk, pk, float_refs, start, n,
                                      out_base, on_audio)
                nblk = (rel + n) // hop  # cut boundaries lie on the lattice
                del peak_pend[:]
                peak_pend.append(pk[nblk:])
                float_refs[:] = [r for r in float_refs
                                 if r[0] + r[1] > start + n]
            else:
                self._write_cut_f32(chunk, start, on_audio)
            del out_pend[:]
            out_pend.append(buf[(rel + n) * unit:])
            out_base = start + n
            cut_i += 1
            if final and cut_i == len(plan.cuts):
                break
        return cut_i, out_base

    def _write_cut_f32(self, chunk: np.ndarray, abs_start: int, on_audio):
        """Reference write_clamped (src/process_tomatis.py:331-357)."""
        s = max(0, abs_start)
        e = min(self.total, abs_start + len(chunk))
        if e <= s or on_audio is None:
            return
        out = chunk[s - abs_start:e - abs_start]
        if self.output_gain != 1.0:
            out = out * self.output_gain
        peak = float(np.max(np.abs(out))) if out.size else 0.0
        if peak > PEAK_LIMIT:
            out = out * (PEAK_LIMIT / peak)
        self.audio_samples_written += len(out)
        on_audio(np.asarray(out, np.float32))

    def _write_cut_pcm24(self, chunk_bytes: np.ndarray, peaks: np.ndarray,
                         float_refs, abs_start: int, n: int, out_base: int,
                         on_audio):
        """Bytes pass straight through unless this flush cut needs the
        reference's peak clamp. Block peaks (pre-quantisation) gate the
        decision conservatively; a triggered clamp pulls the
        pre-quantisation floats from the kept device tensors, rescales
        exactly and re-encodes on the host."""
        C = self.engine.channels
        hop = self.engine.hop
        s = max(0, abs_start)
        e = min(self.total, abs_start + n)
        if e <= s or on_audio is None:
            return
        out = chunk_bytes[(s - abs_start) * C * 3:(e - abs_start) * C * 3]
        peak = 0.0
        if len(peaks):
            b0 = (s - out_base) // hop
            b1 = -(-(e - out_base) // hop)
            window = peaks[b0:b1]
            peak = float(np.max(window)) if len(window) else 0.0
        if peak > PEAK_LIMIT:
            x = self._gather_floats(float_refs, s, e, C)
            true_peak = float(np.max(np.abs(x))) if x.size else 0.0
            if true_peak > PEAK_LIMIT:
                x = x * (PEAK_LIMIT / true_peak)
            out = _encode_pcm24(x)
        self.audio_samples_written += len(out) // (C * 3)
        on_audio(out)

    @staticmethod
    def _gather_floats(float_refs, s: int, e: int, channels: int):
        """Assemble pre-quantisation floats for [s, e) from kept refs
        (device tensors are sliced there and copied to the host)."""
        out = np.zeros((e - s, channels), np.float32)
        for r_start, r_n, arr in float_refs:
            lo = max(s, r_start)
            hi = min(e, r_start + r_n)
            if hi <= lo:
                continue
            out[lo - s:hi - s] = _host(arr[lo - r_start:hi - r_start])
        return out


def _encode_pcm24(x: np.ndarray) -> np.ndarray:
    """float [n, C] -> interleaved little-endian 24-bit bytes [n*C*3]."""
    v = np.clip(np.rint(x * 8388608.0), -8388608, 8388607).astype(np.int32)
    return le24_from_i32(v.reshape(-1))


class SinkState:
    """Routing state of one output stream: pending encoded pieces,
    per-hop-block peaks, pre-quantisation float refs (the clamped-flush
    path), flush-cut cursor and C1/C2 counters."""

    def __init__(self, pad: int):
        self.out_pend: list = []
        self.peak_pend: list = []
        self.float_refs: list = []
        self.out_base = -pad
        self.cut_i = 0
        self.states_count = np.zeros(3, np.int64)

    def route(self, runner, eng, c_frame0, c_nf, payload, aux, out_dev,
              on_frames, write, pcm24: bool = True) -> None:
        """Route one chunk: per-frame log, pending output, flush-cut
        drain, file write. payload: PCM_24 bytes (pcm24) or float samples.
        eng: the chunk's engine (the ramp uses several)."""
        hop = eng.hop
        pad = runner.plan.pad
        log = {"levels": aux[0, :c_nf]}
        for i, k in enumerate(eng.log_keys):
            log[k] = aux[1 + i, :c_nf]
        if "states" in log:
            log["states"] = log["states"].astype(np.int32)
            self.states_count[1] += int(np.sum(log["states"] == 1))
            self.states_count[2] += int(np.sum(log["states"] == 2))
        if on_frames is not None:
            starts = -pad + (c_frame0 + np.arange(c_nf)) * hop
            on_frames(c_frame0, starts, log)
        if c_nf < eng.frames_per_chunk:
            # partial (final) chunk: the stream's OLA tail lies at nf*hop,
            # inside the emit region, already normalised
            emit_n = c_nf * hop + eng.tail_len
        else:
            emit_n = c_nf * hop
        if pcm24:
            self.out_pend.append(payload[:emit_n * eng.channels * 3])
            self.peak_pend.append(aux[-1][:emit_n // hop])
            self.float_refs.append((-pad + c_frame0 * hop, emit_n, out_dev))
        else:
            self.out_pend.append(payload[:emit_n])
        self.cut_i, self.out_base = runner._drain(
            self.out_pend, self.peak_pend, self.float_refs, self.cut_i,
            self.out_base, False, write)

    def append_tail(self, runner, eng, n_frames: int, out_tail, w_tail,
                    pcm24: bool = True) -> None:
        """After a final FULL chunk the carry still holds the stream's OLA
        tail (past the emit region): normalise, gain, and queue it."""
        tail_np = _host(out_tail) / (_host(w_tail)[:, None] + EPS)
        if not pcm24:
            self.out_pend.append(tail_np)
            return
        hop, C = eng.hop, eng.channels
        tail_out = tail_np * np.float32(runner.output_gain)
        nblk = eng.tail_len // hop
        if nblk:
            self.peak_pend.append(np.max(np.abs(
                tail_out.reshape(nblk, hop, C)), axis=(1, 2)))
        self.out_pend.append(_encode_pcm24(tail_out))
        self.float_refs.append((-runner.plan.pad + n_frames * hop,
                                eng.tail_len, tail_out))

    def final_drain(self, runner, write) -> None:
        runner._drain(self.out_pend, self.peak_pend, self.float_refs,
                      self.cut_i, self.out_base, True, write)
