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

The stream loop dispatches single-threaded and in order; the reference's
threaded pipeline and process staging hide a tunnelled link and are
queued in ROADMAP.md, as is the wire transport. Checkpoint/resume
(engine/checkpoint.py) snapshots the stream state between chunks, under
the reference's .npz key names.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tomatis_tpu_torch.ops import cuda_ola, stft
from tomatis_tpu_torch.ops.dsp import EPS, PEAK_LIMIT, frame_levels_dbfs
from tomatis_tpu_torch.utils.pcm import le24_from_i32
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

    Returns (resolved transport, byte_payload). On the port "auto" picks
    pcm24 on a raw-capable sink (the reference's choice for PCIe-attached
    hosts), f32 otherwise. "wire" is not yet ported."""
    if transport not in ("auto", "wire", "pcm24", "f32"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "wire":
        raise ValueError("the 'wire' transport is not yet ported to the "
                         "PyTorch package (queued in ROADMAP.md); use "
                         "pcm24 or f32")
    if transport == "auto":
        transport = "pcm24" if supports_raw else "f32"
    elif transport == "pcm24" and not supports_raw:
        raise ValueError("transport 'pcm24' requires a sink that accepts "
                         "raw PCM_24 bytes")
    return transport, transport == "pcm24"


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
            raise ValueError(transport)
        if norm not in ("eps", "floor8"):
            raise ValueError(norm)
        self.log_keys = tuple(getattr(controller, "LOG_KEYS", ()))
        log_keys = self.log_keys
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


class StreamRunner:
    """Runs a controller over an audio stream with reference write semantics.

    The caller supplies sinks, called in stream order on the calling
    thread:
        on_frames(frame_idx0, starts, log)   per engine chunk (host arrays)
        on_audio(chunk)                      clamped output in file order:
                                             float [n, C] (f32) or PCM_24
                                             bytes (pcm24)
    """

    def __init__(self, engine: ChunkedStftEngine, controller, total: int,
                 output_gain_db: float = 0.0, transport: str = "f32"):
        """transport="pcm24" quantises and packs PCM_24 bytes on the device;
        the per-flush clamp decision then uses device-computed per-hop-block
        peaks, and the (rare) clamped flush rescales the pre-quantisation
        floats and re-encodes on the host: <= 1 LSB from the f32 path."""
        self.engine = engine
        self.controller = controller
        self.total = int(total)
        self.output_gain = float(10.0 ** (output_gain_db / 20.0)) \
            if output_gain_db else 1.0
        self.plan = flush_plan(total, engine.n_fft, engine.hop)
        self.transport = transport
        self.chunk_fn = engine.make_chunk_fn(controller, transport=transport)
        # Ramp-up schedule (F/4, F/2, then F): kept from the reference so
        # that a stream is cut into the same chunks, and so sums in the
        # same order, on both packages.
        F_c = engine.frames_per_chunk
        self._by_F = {F_c: (engine, self.chunk_fn)}
        self._ramp = bool(self.plan.n_frames > 2 * F_c and F_c % 4 == 0
                          and F_c // 4 >= 64 and not ramp_disabled())
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
            on_progress: Callable | None = None) -> dict:
        """ckpt: optional engine.checkpoint.CheckpointManager; the stream
        state is saved before the dispatch of every ckpt.every-th chunk.
        resume_state: a state dict previously returned by ckpt.load(); the
        caller must position its sinks at the offsets in
        resume_state["__meta__"]["scalars"] (audio_samples_written,
        frames_consumed) before calling."""
        t_run = time.perf_counter()
        eng, plan = self.engine, self.plan
        hop, C = eng.hop, eng.channels
        pad, n_frames = plan.pad, plan.n_frames

        if self.total <= 0 or n_frames <= 0:
            self.stats = dict(n_frames=0, c1_frames=0, c2_frames=0,
                              c1_ratio=0.0, c2_ratio=0.0, chunks=0,
                              timings={})
            return self.stats

        ctl_carry = self.controller.init_carry()
        out_tail, w_tail = eng.zero_tails()
        pcm24 = self.transport == "pcm24"
        sink = SinkState(pad)
        self.audio_samples_written = 0
        frame0 = 0

        if resume_state is not None:
            sc = resume_state["__meta__"]["scalars"]
            frame0 = int(sc["frame0"])
            sink.out_base = int(sc["out_base"])
            sink.cut_i = int(sc["cut_i"])
            self.audio_samples_written = int(sc["audio_samples_written"])
            sink.states_count = resume_state["states_count"].copy()
            leaves = [torch.as_tensor(resume_state[f"carry{i}"],
                                      device=eng.device)
                      for i in range(int(sc["n_carry_leaves"]))]
            ctl_carry = _carry_like(ctl_carry, leaves)
            out_tail = torch.as_tensor(resume_state["out_tail"],
                                       device=eng.device)
            w_tail = torch.as_tensor(resume_state["w_tail"],
                                     device=eng.device)
            if resume_state["out_pend"].size:
                sink.out_pend = [resume_state["out_pend"]]
            if resume_state["peak_pend"].size:
                sink.peak_pend = [resume_state["peak_pend"]]
            fr = resume_state.get("ref_floats")
            if fr is not None and fr.size:
                # the pre-quantisation floats of the pending samples, held
                # on the host from here on (_gather_floats takes both)
                sink.float_refs = [(sink.out_base, len(fr), fr)]

        # rolling input in absolute sample coordinates (the stream starts
        # at -pad); a resumed run seeks the source to its first chunk
        in_base = -pad + frame0 * hop
        if in_base > 0:
            if isinstance(source, np.ndarray):
                source = source[in_base:]
            else:
                source.seek(in_base)
        reader = RollingReader(_read_fn(source), C, dtype=np.float32,
                               left_pad=max(0, -in_base), base=in_base,
                               block=eng.emit_len)

        def save_checkpoint():
            """The state before the dispatch of the chunk at frame0, as
            host copies. The loop is single-threaded, so every earlier
            chunk is already routed and drained."""
            buf = _joined(sink.out_pend, np.uint8 if pcm24 else np.float32)
            n_pend = len(buf) // (C * 3 if pcm24 else 1)
            refs = (self._gather_floats(sink.float_refs, sink.out_base,
                                        sink.out_base + n_pend, C)
                    if pcm24 and n_pend else np.zeros((0, C), np.float32))
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

        # host wall time per stage: runner set-up (here: carries, tails,
        # resume and the reader; the caller adds the runner's
        # construction), input assembly + upload, chunk step enqueue,
        # readback + routing + sink writes (the readback waits for the
        # device), and the final drain (stream tail and the last flush cut)
        timings = {"runner_setup_s": 0.0, "input_host_s": 0.0,
                   "dispatch_compute_s": 0.0, "consume_s": 0.0,
                   "final_drain_s": 0.0}
        chunks = 0
        last_full = False
        timings["runner_setup_s"] = time.perf_counter() - t_run
        while frame0 < n_frames:
            eng_i, fn_i = self._by_F[self._chunk_F(frame0)]
            nf = min(eng_i.frames_per_chunk, n_frames - frame0)
            last_full = nf == eng_i.frames_per_chunk
            if ckpt is not None and chunks > 0 and chunks % ckpt.every == 0:
                save_checkpoint()

            t0 = time.perf_counter()
            sig = reader.window(-pad + frame0 * hop, eng_i.chunk_input_len)
            sig = torch.from_numpy(np.ascontiguousarray(sig)).to(eng.device)
            t1 = time.perf_counter()
            payload, aux, out_dev, ctl_carry, out_tail, w_tail = fn_i(
                sig, nf, ctl_carry, out_tail, w_tail, self.ctl_params,
                self.gain_f32)
            t2 = time.perf_counter()
            sink.route(self, eng_i, frame0, nf, _host(payload), _host(aux),
                       out_dev, on_frames, on_audio, pcm24)
            t3 = time.perf_counter()
            timings["input_host_s"] += t1 - t0
            timings["dispatch_compute_s"] += t2 - t1
            timings["consume_s"] += t3 - t2

            frame0 += nf
            chunks += 1
            if frame0 < n_frames:
                reader.advance(-pad + frame0 * hop)
            if on_progress is not None:
                on_progress(frame0, n_frames)
        # if the last chunk was full, the stream's tail is still in the
        # carry (a checkpoint is always taken before a chunk's dispatch, so
        # a resumed run re-enters the loop and derives last_full again)
        t0 = time.perf_counter()
        if last_full:
            sink.append_tail(self, eng, n_frames, out_tail, w_tail, pcm24)
        sink.final_drain(self, on_audio)
        timings["final_drain_s"] = time.perf_counter() - t0

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
