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

from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                StreamRunner,
                                                resolve_transport)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.controllers import GateSelectController
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
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
    file path's device quantise and returns the PCM_24 samples as floats.
    """
    p = p or StandardParams()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    runner = make_runner(p, sr, x.shape[1], len(x), frames_per_chunk,
                         transport=transport, device=device,
                         controller=controller)
    outs = []
    stats = runner.run(x, on_audio=outs.append)
    if not outs:
        return np.zeros_like(x), stats
    if transport == "pcm24":
        v = i32_from_le24(np.concatenate(outs))
        y = (v.astype(np.float32) / 8388608.0).reshape(-1, x.shape[1])
    else:
        y = np.concatenate(outs, 0)
    return y, stats


def process(in_path, out_path, p: StandardParams | None = None,
            state_csv_path=None, frames_per_chunk: int = 1024,
            checkpoint_path=None, progress=None, transport: str = "auto",
            device="cuda", controller=None) -> dict:
    """File-to-file processing with reference CLI semantics.

    - validates 48 kHz stereo when p.require_48k_stereo (ref :234-237)
    - writes WAV PCM_24 (FLAC is not yet ported and raises ValueError)
    - optional per-frame state CSV (ref :302-307,408-409)
    - checkpoint_path is refused: checkpoint/resume is not yet ported
    """
    t_start = time.perf_counter()
    p = p or StandardParams()
    if checkpoint_path:
        raise NotImplementedError(
            "checkpoint/resume is not yet ported to the PyTorch package "
            "(queued in ROADMAP.md)")
    dev = resolve_device(device)
    # resolve the transport before any file is opened: a rejected value
    # must not truncate an existing output
    transport, byte_payload = resolve_transport(transport, True)
    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        if p.require_48k_stereo:
            if sr != 48000:
                raise ValueError(f"expected 48kHz, got {sr} Hz")
            if ch != 2:
                raise ValueError(f"expected stereo, got {ch} channels")
        fout, actual_out = open_checkpointed_sink(out_path, sr, ch)
        csvw = None
        try:
            runner = make_runner(p, sr, ch, total, frames_per_chunk,
                                 transport=transport, device=dev,
                                 controller=controller)
            csvw = (StateCsvWriter(state_csv_path, sr, total)
                    if state_csv_path else None)
            stats = runner.run(fin,
                               on_audio=(fout.write_raw if byte_payload
                                         else fout.write),
                               on_frames=csvw.on_frames if csvw else None,
                               on_progress=progress)
        finally:
            fout.close()
            if csvw:
                csvw.close()

    wall = time.perf_counter() - t_start
    stats.update(params=asdict(p), sr=sr, channels=ch, total=total,
                 threshold_dbfs=p.threshold_dbfs(), out_path=actual_out,
                 device=str(dev), transport=transport, wall_seconds=wall,
                 realtime_factor=(total / sr) / wall if wall > 0 else 0.0)
    return stats


def open_checkpointed_sink(out_path, sr, ch):
    """Open the PCM_24 sink a processor writes to (the reference's
    uncheckpointed branch). An encoder that cannot be built (RuntimeError)
    falls back to WAV beside the requested path with a conversion hint; a
    container the port does not have (FLAC) raises ValueError instead.

    Returns (fout, actual_out)."""
    out_path = str(out_path)
    try:
        return audio.AudioFile(out_path, "w", samplerate=sr, channels=ch,
                               subtype="PCM_24"), out_path
    except RuntimeError as enc_err:
        actual_out = _wav_sibling(out_path)
        print(f"[WARN] cannot encode {out_path!r} ({enc_err}); "
              f"writing WAV instead: {actual_out}")
        return audio.AudioFile(actual_out, "w", samplerate=sr, channels=ch,
                               subtype="PCM_24"), actual_out


def _wav_sibling(path: str) -> str:
    """`x.flac` -> `x.wav`; extension-less paths just append (splitext,
    not rsplit('.') — a dot in a parent directory must not truncate)."""
    return os.path.splitext(path)[0] + ".wav"

