"""Standard Tomatis processor, PyTorch port of tomatis_tpu/models/standard.py.

Capability parity with ref src/process_tomatis.py (CLI flags :488-515,
process() :160-479) on the chunked stream engine: batched frame levels,
prefix-scan gate, one rFFT bank per chunk, K-way OLA kernel.
"""
from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass

import numpy as np

from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                StreamRunner, ramp_disabled,
                                                resolve_transport)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.io.wav import WavWriter
from tomatis_tpu_torch.models.controllers import GateSelectController
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.utils.pcm import i32_from_le24
from tomatis_tpu_torch.utils.stateio import StateCsvWriter


@dataclass
class StandardParams:
    """All knobs of the standard processor (defaults = reference CLI
    defaults, src/process_tomatis.py:488-515)."""
    gate_ui: float = 50.0
    gate_mode: str = "log_percent"      # or "linear"
    dynamic_range: float = 80.0
    gate_scale: float = 1.0
    gate_offset: float = -100.0
    hysteresis_db: float = 3.0
    up_delay_ms: float = 250.0
    fc: float = 1000.0
    slope: float = 12.0
    c1_low: float = +15.0
    c1_high: float = -15.0
    c2_low: float = -15.0
    c2_high: float = +15.0
    n_fft: int = 4096
    hop: int = 2048
    output_gain_db: float = 0.0
    require_48k_stereo: bool = True     # reference hard check (:234-237)

    def threshold_dbfs(self) -> float:
        if self.gate_mode == "log_percent":
            return float(dsp.gate_ui_to_dbfs_log_percent(
                self.gate_ui, self.dynamic_range))
        return float(dsp.gate_ui_to_dbfs(
            self.gate_ui, self.gate_scale, self.gate_offset))


def build_controller(p: StandardParams, sr: int,
                     device="cuda") -> GateSelectController:
    freqs = stft.rfft_freqs(p.n_fft, sr)
    g1 = dsp.db_to_lin(dsp.build_tilt_gain_db(
        freqs, p.fc, p.slope, p.c1_low, p.c1_high))
    g2 = dsp.db_to_lin(dsp.build_tilt_gain_db(
        freqs, p.fc, p.slope, p.c2_low, p.c2_high))
    T = p.threshold_dbfs()
    ton = T + p.hysteresis_db / 2.0
    toff = T - p.hysteresis_db / 2.0
    up_delay_samples = int(sr * p.up_delay_ms / 1000.0)
    delay_frames = gate_ops.updelay_frames(up_delay_samples, p.hop)
    return GateSelectController(g1, g2, ton, toff,
                                delay_frames).to(resolve_device(device))


def make_runner(p: StandardParams, sr: int, channels: int, total: int,
                frames_per_chunk: int = 1024, transport: str = "f32",
                device="cuda", controller=None) -> StreamRunner:
    """controller: a prebuilt GateSelectController (e.g. from convert.py);
    built from p when None."""
    dev = resolve_device(device)
    engine = ChunkedStftEngine(p.n_fft, p.hop, channels, frames_per_chunk,
                               device=dev)
    ctl = (build_controller(p, sr, dev) if controller is None
           else controller.to(dev))
    return StreamRunner(engine, ctl, total, output_gain_db=p.output_gain_db,
                        transport=transport)


def process_array(x: np.ndarray, sr: int, p: StandardParams | None = None,
                  frames_per_chunk: int = 1024, device="cuda",
                  transport: str = "f32", controller=None):
    """In-memory processing: returns (y [N, C] float32, stats dict).

    Same math as process() without file I/O. transport="pcm24" runs the
    file path's device quantise and returns the PCM_24 samples as floats;
    "f32" and "pcm24" are the transports.
    """
    p = p or StandardParams()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    return run_array(lambda: make_runner(
        p, sr, x.shape[1], len(x), frames_per_chunk, transport=transport,
        device=device, controller=controller), x, transport)


def run_array(build_runner, x: np.ndarray, transport: str):
    """Run x [N, C] through the runner that build_runner() makes and
    collect the output as floats: (y [N, C] float32, stats). Shared by the
    processors' process_array. The runner's construction and the decode of
    the collected output are spans of the run's job, timed into
    stats["timings"] beside the stream's own stages: runner_setup_s
    (stream.setup), and output_decode_s (array.collect: the join of the
    flushes and, for pcm24, the numpy PCM_24 decode)."""
    job, pre = trace.new_job(), {}
    with trace.span("stream.setup", pre, "runner_setup_s", job=job):
        runner = build_runner()
    outs = []
    stats = runner.run(x, on_audio=outs.append, job=job)
    if not outs:
        return np.zeros_like(x), stats
    with trace.span("array.collect", pre, "output_decode_s", job=job):
        if transport == "pcm24":
            v = i32_from_le24(np.concatenate(outs))
            y = (v.astype(np.float32) / 8388608.0).reshape(-1, x.shape[1])
        else:
            y = np.concatenate(outs, 0)
    timings = stats["timings"]
    timings["runner_setup_s"] = round(timings["runner_setup_s"]
                                      + pre["runner_setup_s"], 4)
    timings["output_decode_s"] = round(pre["output_decode_s"], 4)
    return y, stats


def process(in_path, out_path, p: StandardParams | None = None,
            state_csv_path=None, frames_per_chunk: int = 1024,
            checkpoint_path=None, checkpoint_every: int = 8,
            progress=None, transport: str = "auto",
            device="cuda", controller=None) -> dict:
    """File-to-file processing with reference CLI semantics.

    - validates 48 kHz stereo when p.require_48k_stereo (ref :234-237)
    - writes FLAC PCM_24 for .flac outputs, WAV PCM_24 otherwise; if FLAC
      encoding is unavailable falls back to .wav (ref :241-251)
    - optional per-frame state CSV (ref :302-307,408-409)
    - checkpoint_path enables chunk-granular crash recovery: stream state
      is persisted every checkpoint_every chunks; re-running the same call
      resumes from the last checkpoint. FLAC outputs stage through a .part
      WAV and are encoded on completion (WAV supports truncate+append).
    """
    p = p or StandardParams()
    dev = resolve_device(device)
    stats = process_file(
        in_path, out_path, p, "standard",
        lambda sr, ch, total, tr: make_runner(
            p, sr, ch, total, frames_per_chunk, transport=tr, device=dev,
            controller=controller),
        state_csv_path=state_csv_path, frames_per_chunk=frames_per_chunk,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        progress=progress, transport=transport)
    stats["device"] = str(dev)
    return stats


def process_file(in_path, out_path, p, model: str, build_runner,
                 state_csv_path=None, frames_per_chunk: int = 1024,
                 checkpoint_path=None, checkpoint_every: int = 8,
                 progress=None, transport: str = "auto",
                 csv_kwargs: dict | None = None) -> dict:
    """The file-to-file run shared by the standard and crossfade
    processors: input checks, checkpoint fingerprint, sink, state CSV,
    run, finalize. p is the processor's params dataclass (its fields are
    the fingerprint, with `model`); build_runner(sr, ch, total, transport)
    makes the StreamRunner; csv_kwargs go to StateCsvWriter. The runner's
    construction adds to stats["timings"]["runner_setup_s"] (a
    stream.setup span) and the sink's close, for FLAC the last partial
    block and the header rewrite, to its encode_s (writer.close)."""
    t_start = time.perf_counter()
    job, pre = trace.new_job(), {}
    # resolve the transport before any file is opened: a rejected value
    # must not truncate an existing output. Every sink here is PCM_24 (WAV
    # or FLAC, including the checkpoint's staging WAV) and takes raw bytes.
    transport, byte_payload = resolve_transport(transport, True)
    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        if p.require_48k_stereo:
            if sr != 48000:
                raise ValueError(f"expected 48kHz, got {sr} Hz")
            if ch != 2:
                raise ValueError(f"expected stereo, got {ch} channels")
        out_path = str(out_path)
        # The fingerprint holds the RESOLVED transport (the persisted
        # pending output is PCM bytes under pcm24 but float samples
        # under f32; an --transport auto checkpoint resumes under an
        # explicit --transport pcm24, the same resolved value), in_path (a checkpoint must not resume against another file
        # of the same shape) and the chunk schedule switch (chunk
        # boundaries decide float summation order). The device is not part
        # of it: a run may resume on another card.
        config = dict(asdict(p), sr=sr, ch=ch, total=total,
                      in_path=str(in_path),
                      frames_per_chunk=frames_per_chunk, model=model,
                      transport=transport, no_ramp=ramp_disabled())
        (fout, actual_out, ckpt, resume_state,
         stage_path) = open_checkpointed_sink(
            out_path, sr, ch, config, checkpoint_path, checkpoint_every)
        csvw = None
        try:
            if not fout.supports_raw:
                raise RuntimeError("process() sinks must take raw PCM_24")
            with trace.span("stream.setup", pre, "runner_setup_s",
                            job=job):
                runner = build_runner(sr, ch, total, transport)
            resume_frame = None
            if resume_state is not None:
                resume_frame = resume_state["__meta__"]["scalars"][
                    "frames_consumed"]
            csvw = (StateCsvWriter(state_csv_path, sr, total,
                                   resume_at_frame=resume_frame,
                                   **(csv_kwargs or {}))
                    if state_csv_path else None)
            stats = runner.run(fin,
                               on_audio=(fout.write_raw if byte_payload
                                         else fout.write),
                               on_frames=csvw.on_frames if csvw else None,
                               ckpt=ckpt, resume_state=resume_state,
                               on_progress=progress, job=job)
            with trace.span("writer.close", stats["timings"] or None,
                            "encode_s", job=job):
                fout.close()
        finally:
            fout.close()
            if csvw:
                csvw.close()
        actual_out = (finalize_checkpointed_sink(ckpt, stage_path, out_path)
                      or actual_out)

    t = stats["timings"]
    if t:
        t["runner_setup_s"] = round(t["runner_setup_s"]
                                    + pre["runner_setup_s"], 4)
        t["encode_s"] = round(t["encode_s"], 4)
    wall = time.perf_counter() - t_start
    stats.update(params=asdict(p), sr=sr, channels=ch, total=total,
                 threshold_dbfs=p.threshold_dbfs(), out_path=actual_out,
                 transport=transport, wall_seconds=wall,
                 realtime_factor=(total / sr) / wall if wall > 0 else 0.0)
    return stats


def _convert_hint(actual_out: str, out_path: str) -> str:
    return (f"       convert later with `python -m tomatis_tpu_torch.cli.main "
            f"convert -i {actual_out} -o {out_path}` (or ffmpeg)")


def open_checkpointed_sink(out_path, sr, ch, config, checkpoint_path,
                           checkpoint_every):
    """Open the PCM_24 sink a processor writes to, shared by the standard
    and crossfade processors.

    Without a checkpoint: the requested container directly, falling back
    to WAV with a conversion hint when its encoder cannot be built (FLAC
    without a C++ compiler; ref src/process_tomatis.py:241-251,471-474).
    With a checkpoint: a staged WAV (WAV supports truncate+append on
    resume), reopened at the persisted sample count when a compatible
    checkpoint and its stage exist. A stale checkpoint (no stage file) is
    cleared now: a crash before the first new snapshot must not resume the
    old offsets against the new stage.

    Returns (fout, actual_out, ckpt, resume_state, stage_path)."""
    out_path = str(out_path)
    if not checkpoint_path:
        try:
            fout = audio.AudioFile(out_path, "w", samplerate=sr,
                                   channels=ch, subtype="PCM_24")
            return fout, out_path, None, None, None
        except (RuntimeError, OSError) as enc_err:
            actual_out = _wav_sibling(out_path)
            print(f"[WARN] cannot encode {out_path!r} ({enc_err}); "
                  f"writing WAV instead: {actual_out}\n"
                  + _convert_hint(actual_out, out_path))
            fout = audio.AudioFile(actual_out, "w", samplerate=sr,
                                   channels=ch, subtype="PCM_24")
            return fout, actual_out, None, None, None

    ckpt = CheckpointManager(checkpoint_path, config, checkpoint_every)
    resume_state = ckpt.load()
    stage_path = (out_path if out_path.lower().endswith(".wav")
                  else out_path + ".part.wav")
    if resume_state is not None and os.path.exists(stage_path):
        sc = resume_state["__meta__"]["scalars"]
        fout = _RawWav(WavWriter.reopen(stage_path,
                                        sc["audio_samples_written"]), ch)
    else:
        if resume_state is not None:
            ckpt.clear()
        resume_state = None
        fout = _RawWav(WavWriter(stage_path, sr, ch, "PCM_24"), ch)
    return fout, out_path, ckpt, resume_state, stage_path


def finalize_checkpointed_sink(ckpt, stage_path, out_path):
    """Epilogue of a checkpointed run: transcode the staged WAV into the
    requested container and drop the checkpoint. No-op without one.

    When the requested container cannot be encoded (FLAC without a C++
    compiler), the completed audio is kept as a WAV next to the requested
    path with a conversion hint: the same degradation as the
    uncheckpointed open. Returns the path actually holding the output, or
    None when there was no checkpoint."""
    if ckpt is None:
        return None
    actual = str(out_path)
    if stage_path != actual:
        try:
            _transcode_wav_to(stage_path, actual)
        except (RuntimeError, OSError) as enc_err:
            try:   # a mid-transcode failure can leave a partial output
                if os.path.exists(actual):
                    os.remove(actual)
            except OSError:
                pass
            actual = _wav_sibling(actual)
            os.replace(stage_path, actual)
            print(f"[WARN] cannot encode {out_path!r} ({enc_err}); "
                  f"kept the completed audio as WAV: {actual}\n"
                  + _convert_hint(actual, str(out_path)))
        else:
            try:
                os.remove(stage_path)
            except OSError:
                pass   # output is complete; a stale stage file is noise
    ckpt.clear()
    return actual


def _wav_sibling(path: str) -> str:
    """`x.flac` -> `x.wav`; extension-less paths just append (splitext,
    not rsplit('.') — a dot in a parent directory must not truncate)."""
    return os.path.splitext(path)[0] + ".wav"


class _RawWav:
    """Minimal AudioFile-like adapter over a bare WavWriter (for the
    checkpointed staging path)."""

    def __init__(self, writer, channels):
        self._w = writer
        self.channels = channels
        self.subtype = writer.subtype

    @property
    def supports_raw(self):
        return self.subtype == "PCM_24"

    def write(self, data):
        self._w.write(data)

    def write_raw(self, raw):
        self._w.write_raw(raw)

    def close(self):
        self._w.close()


def _transcode_wav_to(wav_path, out_path):
    """Stream-copy a staged WAV into the final container (e.g. FLAC)."""
    with audio.AudioFile(wav_path, "r") as fin, \
            audio.AudioFile(str(out_path), "w", samplerate=fin.samplerate,
                            channels=fin.channels, subtype="PCM_24") as fo:
        while True:
            x = fin.read(fin.samplerate * 30)
            if len(x) == 0:
                break
            fo.write(x)
