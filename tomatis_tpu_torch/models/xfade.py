"""Crossfade Tomatis processor, PyTorch port of tomatis_tpu/models/xfade.py
(capability parity with ref src/process_tomatis_xfade.py): the standard
gate plus a rate-limited alpha ramp, gains blended in the dB domain
mid-transition. The alpha ramp runs as a clip-affine prefix scan
(ops.gate.alpha_ramp).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tomatis_tpu_torch.engine.streaming import ChunkedStftEngine, StreamRunner
from tomatis_tpu_torch.models.controllers import GateXfadeController
from tomatis_tpu_torch.models.standard import process_file, run_array
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
from tomatis_tpu_torch.utils.device import resolve_device


@dataclass
class XfadeParams:
    """Defaults = reference CLI (src/process_tomatis_xfade.py:360-390).
    Gate mapping is linear-only in this variant (:28-30)."""
    gate_ui: float = 50.0
    gate_scale: float = 1.0
    gate_offset: float = -100.0
    hysteresis_db: float = 3.0
    up_delay_ms: float = 250.0
    xfade_ms: float = 0.0              # 0 = hard switching
    fc: float = 1000.0
    slope: float = 12.0
    c1_low: float = +15.0
    c1_high: float = -15.0
    c2_low: float = -15.0
    c2_high: float = +15.0
    n_fft: int = 4096
    hop: int = 2048
    require_48k_stereo: bool = True

    def threshold_dbfs(self) -> float:
        return float(dsp.gate_ui_to_dbfs(self.gate_ui, self.gate_scale,
                                         self.gate_offset))

    def xfade_frames(self, sr: int) -> int:
        """ref :152-155: max(1, ceil(xfade_ms / frame_ms)) when enabled."""
        if self.xfade_ms <= 0:
            return 0
        frame_ms = self.hop / sr * 1000.0
        return max(1, int(np.ceil(self.xfade_ms / frame_ms)))


def build_controller(p: XfadeParams, sr: int,
                     device="cuda") -> GateXfadeController:
    freqs = stft.rfft_freqs(p.n_fft, sr)
    g1_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c1_low, p.c1_high)
    g2_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c2_low, p.c2_high)
    T = p.threshold_dbfs()
    up_delay_samples = int(sr * p.up_delay_ms / 1000.0)
    xf = p.xfade_frames(sr)
    return GateXfadeController(
        g1_db, g2_db,
        ton=T + p.hysteresis_db / 2.0, toff=T - p.hysteresis_db / 2.0,
        delay_frames=gate_ops.updelay_frames(up_delay_samples, p.hop),
        # xfade_frames 0 -> step 1.0: a hard switch
        xfade_frames=xf if xf > 0 else 1).to(resolve_device(device))


def make_runner(p: XfadeParams, sr: int, channels: int, total: int,
                frames_per_chunk: int = 1024, transport: str = "f32",
                device="cuda", controller=None) -> StreamRunner:
    """controller: a prebuilt GateXfadeController (e.g. from convert.py);
    built from p when None."""
    dev = resolve_device(device)
    engine = ChunkedStftEngine(p.n_fft, p.hop, channels, frames_per_chunk,
                               device=dev)
    ctl = (build_controller(p, sr, dev) if controller is None
           else controller.to(dev))
    return StreamRunner(engine, ctl, total, transport=transport)


def process_array(x: np.ndarray, sr: int, p: XfadeParams | None = None,
                  frames_per_chunk: int = 1024, device="cuda",
                  transport: str = "f32", controller=None):
    """In-memory processing: returns (y [N, C] float32, stats dict)."""
    p = p or XfadeParams()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    return run_array(lambda: make_runner(
        p, sr, x.shape[1], len(x), frames_per_chunk, transport=transport,
        device=device, controller=controller), x, transport)


def process(in_path, out_path, p: XfadeParams | None = None,
            state_csv_path=None, frames_per_chunk: int = 1024,
            checkpoint_path=None, checkpoint_every: int = 8,
            progress=None, transport: str = "auto", device="cuda",
            controller=None) -> dict:
    """File-to-file crossfade processing; checkpoint_path enables the same
    chunk-granular crash recovery as the standard processor, transport as
    in models.standard.process. The state CSV carries an alpha column
    (level %.2f, alpha %.3f)."""
    p = p or XfadeParams()
    dev = resolve_device(device)
    stats = process_file(
        in_path, out_path, p, "xfade",
        lambda sr, ch, total, tr: make_runner(
            p, sr, ch, total, frames_per_chunk, transport=tr, device=dev,
            controller=controller),
        state_csv_path=state_csv_path, frames_per_chunk=frames_per_chunk,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        progress=progress, transport=transport,
        csv_kwargs=dict(with_alpha=True, level_fmt="%.2f",
                        alpha_fmt="%.3f"))
    stats.update(xfade_frames=p.xfade_frames(stats["sr"]), device=str(dev))
    return stats
