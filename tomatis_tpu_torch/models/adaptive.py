"""Adaptive Tomatis processor, PyTorch port of
tomatis_tpu/models/adaptive.py (capability parity with
ref src/process_tomatis_adaptive.py).

Pipeline: pre-attenuation for headroom -> batched frame levels -> binary
search of the gate threshold to a target C2 ratio (each probe runs the
min-hold gate as a prefix scan on the device) -> snap-first alpha ramp ->
one-shot chunked STFT pass with per-frame dB-blended gains -> restore
attenuation -> global peak protect.

Reference semantics preserved exactly:
- only frames whose start lies in [0, total) are processed (pad-region
  frames are *excluded*, unlike the standard processor: ref :70-79,299),
- normalizer is max(sum win^2, 1e-8) cropped to [0, total) (ref :329-332),
- peak protect is a single global rescale (ref :340-345), not per-flush,
- any sample rate / channel count is accepted (ref :179-183).

The STFT pass is the stream engine's chunk step built with norm="floor8"
on the f32 transport: one launch of the fused chunk-tail kernel per chunk
on a CUDA tensor. The closing tail piece divides by the same floor
(ops.cuda_ola.FLOOR8).

Each call takes a job id (utils/trace.py::new_job, "job_id" in the
result) and times its stages with utils/trace.py spans, summed into
"timings": adaptive.peak_scan (peak_scan_s), adaptive.levels (levels_s),
adaptive.search (threshold_search_s, a row-only adaptive.probe child per
probe; "search_probes" counts them), adaptive.gate_ramp (gate_ramp_s),
adaptive.csv (state_csv_s), adaptive.pass3 (pass3_s; children
adaptive.step, step_s, and adaptive.stage_write, stage_write_s),
adaptive.finalize (restore_protect_s; children adaptive.stage_read, a
row only, and writer.encode / writer.close, encode_s), and
adaptive.decode (decode_s) around every read of the input file, inside
the pass that reads.
"""
from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, asdict

import numpy as np
import torch

from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
from tomatis_tpu_torch.engine.streaming import ChunkedStftEngine, _host
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.io.wav import WavWriter
from tomatis_tpu_torch.models.controllers import AlphaGainController
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
from tomatis_tpu_torch.ops.cuda_ola import FLOOR8
from tomatis_tpu_torch.ops.dsp import EPS, PEAK_LIMIT
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.utils.rolling import RollingReader

# frames per device call of the levels pass (the reference's fixed shape)
LEVEL_FRAMES = 4096


@dataclass
class AdaptiveParams:
    """Defaults = reference CLI (src/process_tomatis_adaptive.py:376-400)."""
    fc: float = 1000.0
    slope: float = 12.0
    c1_low: float = 15.0
    c1_high: float = -15.0
    c2_low: float = -15.0
    c2_high: float = 15.0
    target_c2: float = 0.5
    hyst_db: float = 3.0
    min_hold_ms: float = 250.0
    xfade_ms: float = 500.0
    headroom_margin: float = 2.0
    n_fft: int = 4096
    hop: int = 2048
    silence_threshold: float = -70.0

    def min_hold_frames(self, sr: int) -> int:
        return int(np.ceil(self.min_hold_ms / (self.hop / sr * 1000.0)))

    def xfade_frames(self, sr: int) -> int:
        return int(np.ceil(self.xfade_ms / (self.hop / sr * 1000.0)))


def frame_window(total: int, n_fft: int, hop: int):
    """In-range frame window of the adaptive processor: frame k starts at
    k*hop in padded coords; in-range iff 0 <= k*hop - pad < total and
    k*hop + n_fft <= total + 2*pad (ref :70-79). Returns (k0, F).

    The streaming file pipeline's equal-to-process_array guarantee
    depends on every pass using this one definition."""
    pad = n_fft // 2
    k0 = -(-pad // hop)
    k1_excl = min((total + 2 * pad - n_fft) // hop,
                  (total + pad - 1) // hop) + 1
    return k0, max(0, k1_excl - k0)


def _levels_of(sig: np.ndarray, n_fft: int, hop: int, nf: int,
               dev) -> np.ndarray:
    """Levels of the first nf frames of a host slice, on the device."""
    t = torch.from_numpy(np.ascontiguousarray(sig, np.float32)).to(dev)
    return _host(stft.frame_levels_chunk(t, n_fft, hop, nf))


def compute_frame_levels(x: np.ndarray, p: AdaptiveParams,
                         frames_per_chunk: int = LEVEL_FRAMES,
                         device="cuda"):
    """Per-frame RMS dBFS of the in-range frames (ref :57-84), batched on
    the device in chunks of frames_per_chunk frames (the last one as long
    as it is: no shape is compiled here, so none needs padding).
    Returns (levels [F], valid_mask)."""
    dev = resolve_device(device)
    n_fft, hop = p.n_fft, p.hop
    pad = n_fft // 2
    total, ch = x.shape
    k0, F = frame_window(total, n_fft, hop)
    if F == 0:
        return np.zeros(0, np.float32), np.zeros(0, bool)

    xp = np.concatenate([np.zeros((pad, ch), np.float32), x,
                         np.zeros((pad, ch), np.float32)])
    base = k0 * hop

    levels = np.empty(F, np.float32)
    for f0 in range(0, F, frames_per_chunk):
        nf = min(frames_per_chunk, F - f0)
        s = base + f0 * hop
        levels[f0:f0 + nf] = _levels_of(xp[s:s + (nf - 1) * hop + n_fft],
                                        n_fft, hop, nf, dev)
    valid = levels > p.silence_threshold
    return levels, valid


def find_optimal_threshold(levels, valid: np.ndarray,
                           hyst_db: float, min_hold_frames: int,
                           target_c2: float, device="cuda") -> float:
    """Binary search (<=30 iters, +-1% tolerance) over [p5, p95] of valid
    levels (ref :124-154); each probe is one prefix-scan gate run on the
    device and reads one scalar back."""
    return _search(levels, valid, hyst_db, min_hold_frames, target_c2,
                   device)[0]


def _search(levels, valid: np.ndarray, hyst_db: float, min_hold_frames: int,
            target_c2: float, device="cuda", job: int = 0) -> tuple:
    """find_optimal_threshold's search -> (threshold, probes run); each
    probe an adaptive.probe span (a row only)."""
    dev = resolve_device(device)
    levels = np.asarray(levels, np.float32)
    valid_levels = levels[valid]
    if len(valid_levels) == 0:
        return float(np.median(levels)), 0
    t_low = float(np.percentile(valid_levels, 5))
    t_high = float(np.percentile(valid_levels, 95))
    best_t = float(np.median(valid_levels))
    best_diff = 1.0
    lv = torch.from_numpy(levels).to(dev)

    def c2_ratio(ton, toff):
        states, _ = gate_ops.gate_minhold(lv, ton, toff, min_hold_frames)
        # the count is exact, the division is the host's float64 as
        # np.mean's
        return int((states == 2).sum()) / len(levels)

    probes = 0
    for _ in range(30):
        t_mid = (t_low + t_high) / 2.0
        with trace.span("adaptive.probe", job=job, at=probes):
            r = float(c2_ratio(t_mid + hyst_db / 2.0, t_mid - hyst_db / 2.0))
        probes += 1
        diff = abs(r - target_c2)
        if diff < best_diff:
            best_diff = diff
            best_t = t_mid
        if diff < 0.01:
            break
        if r < target_c2:
            t_high = t_mid
        else:
            t_low = t_mid
    return best_t, probes


def _chunk_step(p: AdaptiveParams, sr: int, ch: int, alpha: np.ndarray,
                frames_per_chunk: int, dev):
    """The pass-3 chunk step: (engine, controller, chunk_fn) with the
    whole-file alpha track as the controller's table and norm="floor8"."""
    n_fft = p.n_fft
    F = len(alpha)
    freqs = stft.rfft_freqs(n_fft, sr)
    g1_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c1_low, p.c1_high)
    g2_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c2_low, p.c2_high)
    pad_alpha = np.zeros(((F + frames_per_chunk) // frames_per_chunk + 1)
                         * frames_per_chunk, np.float32)
    pad_alpha[:F] = alpha
    controller = AlphaGainController(g1_db, g2_db, pad_alpha).to(dev)
    engine = ChunkedStftEngine(n_fft, p.hop, ch, frames_per_chunk,
                               device=dev)
    return engine, controller, engine.make_chunk_fn(controller,
                                                    norm="floor8")


def _closing_tail(out_tail, w_tail) -> np.ndarray:
    """The stream's tail left in the carry after a final FULL chunk,
    normalised with the chunk step's floor."""
    return _host(out_tail) / np.maximum(_host(w_tail)[:, None],
                                        np.float32(FLOOR8))


def process_array(x: np.ndarray, sr: int, p: AdaptiveParams | None = None,
                  frames_per_chunk: int = 1024, device="cuda"):
    """In-memory adaptive processing. Returns (y, info dict);
    info["timings"] holds the span totals of each stage (the module's
    docstring), info["search_probes"] the threshold search's probes and
    info["job_id"] the call's job id."""
    dev = resolve_device(device)
    p = p or AdaptiveParams()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    total, ch = x.shape
    n_fft, hop = p.n_fft, p.hop
    pad = n_fft // 2
    min_hold = p.min_hold_frames(sr)
    xfade = p.xfade_frames(sr)
    job, timings = trace.new_job(), {}

    # 1. pre-attenuation (ref :201-215)
    with trace.span("adaptive.peak_scan", timings, "peak_scan_s", job=job):
        input_peak = float(np.max(np.abs(x))) if x.size else 0.0
        atten_db, catt, _ = atten_plan(p, input_peak)
        x_atten = x * catt

    # 2. levels + adaptive threshold (ref :219-226)
    with trace.span("adaptive.levels", timings, "levels_s", job=job):
        levels, valid = compute_frame_levels(x_atten, p, device=dev)
    F = len(levels)
    if F == 0:
        return x.copy(), dict(n_frames=0, optimal_threshold=0.0,
                              c2_ratio=0.0, switch_count=0,
                              atten_db=atten_db, levels=levels,
                              states=np.zeros(0, np.int32),
                              alpha=np.zeros(0, np.float32),
                              search_probes=0, device=str(dev),
                              timings=timings, job_id=job)
    # 2b-4. threshold search, min-hold gate, run stats, snap-first alpha
    # (ref :219-265): one plan shared with process()
    plan = gate_plan(levels, p, min_hold, xfade, device=dev, job=job)
    optimal_t = plan["optimal_t"]
    states, alpha = plan["states"], plan["alpha"]
    run_stats = plan["run_stats"]
    short_runs, n_runs = plan["short_runs"], plan["n_runs"]
    timings.update(plan["timings"])

    # 5. one-shot chunked STFT pass with per-frame blended gains
    with trace.span("adaptive.pass3", timings, "pass3_s", job=job):
        engine, controller, chunk_fn = _chunk_step(p, sr, ch, alpha,
                                                   frames_per_chunk, dev)
        ctl_params = controller.params()
        gain_one = torch.ones((), dtype=torch.float32, device=dev)

        xp = np.concatenate([np.zeros((pad, ch), np.float32), x_atten,
                             np.zeros((pad, ch), np.float32)])
        k0 = -(-pad // hop)
        base = k0 * hop - pad      # absolute coord of first frame's start
        ctl_carry = controller.init_carry()
        out_tail, w_tail = engine.zero_tails()
        pieces = []
        need = engine.chunk_input_len
        nf = 0
        for f0 in range(0, F, frames_per_chunk):
            nf = min(frames_per_chunk, F - f0)
            s = k0 * hop + f0 * hop
            sig = xp[s:s + need]
            if len(sig) < need:
                sig = np.concatenate(
                    [sig, np.zeros((need - len(sig), ch), np.float32)])
            with trace.span("adaptive.step", timings, "step_s", job=job,
                            at=f0):
                emit, _aux, _, ctl_carry, out_tail, w_tail = chunk_fn(
                    torch.from_numpy(np.ascontiguousarray(sig)).to(dev), nf,
                    ctl_carry, out_tail, w_tail, ctl_params, gain_one)
                if nf < frames_per_chunk:
                    pieces.append(_host(emit[:nf * hop + engine.tail_len]))
                else:
                    pieces.append(_host(emit[:nf * hop]))
        if nf == frames_per_chunk:
            pieces.append(_closing_tail(out_tail, w_tail))
        ystream = np.concatenate(pieces, 0)  # from absolute coord `base`

    with trace.span("adaptive.finalize", timings, "restore_protect_s",
                    job=job):
        # crop to [0, total); samples not covered by any frame stay 0
        # (ref's norm=max(w,1e-8) with zero numerator)
        y = np.zeros((total, ch), np.float32)
        s0 = max(0, base)
        e0 = min(total, base + len(ystream))
        if e0 > s0:
            y[s0:e0] = ystream[s0 - base:e0 - base]

        # 6. restore attenuation + global peak protect (ref :334-345)
        if atten_db > 0:
            y = y * np.float32(10.0 ** (atten_db / 20.0))
        peak = float(np.max(np.abs(y))) if y.size else 0.0
        if peak > PEAK_LIMIT:
            y = y * np.float32(PEAK_LIMIT / peak)

    duration_min = total / sr / 60.0
    info = dict(
        n_frames=F,
        optimal_threshold=float(optimal_t),
        c2_ratio=run_stats["c2_ratio"],
        switch_count=run_stats["switch_count"],
        switches_per_min=(run_stats["switch_count"] / duration_min
                          if duration_min > 0 else 0.0),
        short_run_ratio=short_runs / n_runs if n_runs else 0.0,
        atten_db=atten_db,
        min_hold_frames=min_hold,
        xfade_frames=xfade,
        levels=levels, states=states, alpha=alpha,
        search_probes=plan["search_probes"],
        device=str(dev), timings=timings, job_id=job,
    )
    return y, info


def _write_state_csv(state_csv_path, info, hop, sr):
    """Adaptive state CSV: i+1, (i+1)*hop/sr %.6f, level %.4f, state,
    alpha %.4f (ref :354-362)."""
    frame_sec = hop / sr
    with open(state_csv_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["frame_idx", "time_sec", "level_dbfs", "state",
                    "alpha"])
        for i in range(info["n_frames"]):
            w.writerow([i + 1, "%.6f" % ((i + 1) * frame_sec),
                        "%.4f" % info["levels"][i],
                        "C1" if info["states"][i] == 1 else "C2",
                        "%.4f" % info["alpha"][i]])


def _decoding(read, acc: dict | None, job: int):
    """An input file's read with every call an adaptive.decode span, its
    time into acc["decode_s"]."""
    def decode(n):
        with trace.span("adaptive.decode", acc, "decode_s", job=job):
            return read(n)
    return decode


def _stream_levels(fin, total: int, ch: int, p: AdaptiveParams,
                   catt: np.float32, frames_per_chunk: int = LEVEL_FRAMES,
                   device="cuda", acc: dict | None = None, job: int = 0):
    """Pass 2 of the streaming processor: per-frame RMS dBFS of the
    attenuated stream in bounded memory. Produces the levels of
    compute_frame_levels on the in-RAM attenuated signal (same chunk
    shapes, same f32 per-block attenuation multiply). Its reads are
    adaptive.decode spans into acc["decode_s"]."""
    dev = resolve_device(device)
    n_fft, hop = p.n_fft, p.hop
    pad = n_fft // 2
    k0, F = frame_window(total, n_fft, hop)
    if F == 0:
        return np.zeros(0, np.float32)
    fin.seek(0)
    levels = np.empty(F, np.float32)
    # padded attenuated stream in RollingReader coords (0 = first pad zero)
    reader = RollingReader(_decoding(fin.read, acc, job), ch, scale=catt,
                           left_pad=pad, block=hop * 512)
    for f0 in range(0, F, frames_per_chunk):
        nf = min(frames_per_chunk, F - f0)
        s = (k0 + f0) * hop
        reader.advance(s)
        levels[f0:f0 + nf] = _levels_of(
            reader.window(s, (nf - 1) * hop + n_fft), n_fft, hop, nf, dev)
    return levels


def scan_input_peak(fin, sr: int, acc: dict | None = None,
                    job: int = 0) -> float:
    """Pass 1 of the streaming processors: global input peak in bounded
    memory, 30 s blocks (ref :201-207). fin must be positioned at
    sample 0. Its reads are adaptive.decode spans into acc["decode_s"]."""
    read = _decoding(fin.read, acc, job)
    peak_in = 0.0
    while True:
        blk = read(sr * 30)
        if len(blk) == 0:
            break
        if blk.size:
            peak_in = max(peak_in, float(np.max(np.abs(blk))))
    return peak_in


def atten_plan(p: AdaptiveParams, peak_in: float):
    """Pre-attenuation factors from the global input peak (ref :201-215):
    returns (atten_db, catt, restore) where catt scales the input before
    processing and restore undoes it on the way out."""
    input_peak_dbfs = 20.0 * np.log10(peak_in + EPS)
    max_gain = max(abs(p.c1_low), abs(p.c2_high))
    atten_db = max(0.0, input_peak_dbfs + max_gain + p.headroom_margin)
    catt = np.float32(10.0 ** (-atten_db / 20.0))
    restore = np.float32(10.0 ** (atten_db / 20.0)) if atten_db > 0 \
        else np.float32(1.0)
    return atten_db, catt, restore


def gate_plan(levels: np.ndarray, p: AdaptiveParams, min_hold: int,
              xfade: int, device="cuda", job: int = 0) -> dict:
    """Pass 2 host half: threshold search, min-hold gate, run statistics,
    and the snap-first alpha ramp (ref :219-265). Returns every per-frame
    vector plus the scalars the callers and their result dicts need, the
    search's probe count, and the span totals of the search
    (adaptive.search) and of the gate + ramp (adaptive.gate_ramp)."""
    dev = resolve_device(device)
    timings = {}
    with trace.span("adaptive.search", timings, "threshold_search_s",
                    job=job):
        valid = levels > p.silence_threshold
        optimal_t, probes = _search(levels, valid, p.hyst_db, min_hold,
                                    p.target_c2, device=dev, job=job)
    with trace.span("adaptive.gate_ramp", timings, "gate_ramp_s", job=job):
        states_t, _ = gate_ops.gate_minhold(
            torch.from_numpy(np.asarray(levels, np.float32)).to(dev),
            optimal_t + p.hyst_db / 2.0, optimal_t - p.hyst_db / 2.0,
            min_hold)
        states = _host(states_t)
        run_stats = gate_ops.state_run_stats(states)
        short_runs = int(np.sum(run_stats["run_lengths"] < min_hold))
        n_runs = len(run_stats["run_lengths"])
        astep = 1.0 / xfade if xfade > 0 else 1.0
        alpha = _host(gate_ops.alpha_ramp_snap_first(
            (states_t == 2).to(torch.float32), astep))
    return dict(optimal_t=float(optimal_t), states=states, alpha=alpha,
                astep=astep, run_stats=run_stats, short_runs=short_runs,
                n_runs=n_runs, search_probes=probes, timings=timings)


class StageEmitter:
    """Stream-coordinate pieces -> cropped, attenuation-restored float32
    staging writes with a running global peak (ref :283-345's write-out
    bookkeeping)."""

    def __init__(self, stage, base: int, total: int, ch: int,
                 restore: np.float32, abs_written: int = 0,
                 peak: float = 0.0):
        self._stage = stage
        self._base = base
        self._total = total
        self._ch = ch
        self._restore = restore
        self.abs_written = abs_written
        self.peak = peak

    def emit(self, stream_lo: int, piece: np.ndarray) -> None:
        """Crop a stream-coordinate piece to [0, total), restore the
        attenuation, track the global peak, append to staging."""
        a0 = self._base + stream_lo
        s = max(0, a0)
        e = min(self._total, a0 + len(piece))
        if e <= s:
            return
        if s > self.abs_written:   # leading gap (base > 0): zeros
            self._stage.write(np.zeros((s - self.abs_written, self._ch),
                                       np.float32))
            self.abs_written = s
        out = piece[s - a0:e - a0] * self._restore
        pk = float(np.max(np.abs(out))) if out.size else 0.0
        self.peak = max(self.peak, pk)
        self._stage.write(np.asarray(out, np.float32))
        self.abs_written = e

    def fill_tail(self) -> None:
        """Zero-fill any uncovered region up to total."""
        if self.abs_written < self._total:
            self._stage.write(np.zeros(
                (self._total - self.abs_written, self._ch), np.float32))
            self.abs_written = self._total


def finalize_stage(stage_path, out_path, sr: int, ch: int,
                   peak: float, acc: dict | None = None,
                   job: int = 0) -> None:
    """Global peak protect + quantize the float staging file to the
    PCM_24 output, then drop the staging file (ref :340-351). Its reads
    of the staging file are adaptive.stage_read spans (rows only), its
    writes and the output's close writer.encode and writer.close spans
    into acc["encode_s"]."""
    scale = np.float32(PEAK_LIMIT / peak) if peak > PEAK_LIMIT \
        else np.float32(1.0)
    with audio.AudioFile(stage_path, "r") as fst, \
            audio.AudioFile(out_path, "w", samplerate=sr, channels=ch,
                            subtype="PCM_24") as fo:
        while True:
            with trace.span("adaptive.stage_read", job=job):
                blk = fst.read(sr * 30)
            if len(blk) == 0:
                break
            if scale != 1.0:
                blk = blk * scale
            with trace.span("writer.encode", acc, "encode_s", job=job):
                fo.write(blk)
        with trace.span("writer.close", acc, "encode_s", job=job):
            fo.close()
    os.remove(stage_path)


def process(in_path, out_path, p: AdaptiveParams | None = None,
            state_csv_path=None, frames_per_chunk: int = 1024,
            checkpoint_path=None, checkpoint_every: int = 8,
            progress=None, device="cuda") -> dict:
    """File-to-file adaptive processing (ref :157-373) in BOUNDED memory.

    The reference script reads the whole file into RAM (ref :179, ~2.8 GB
    for an hour of 48 kHz stereo); here the same math runs as three
    streaming passes over the input file:

      1. global input peak            -> pre-attenuation (ref :201-215)
      2. chunked frame levels         -> threshold search, gate, alpha
      3. chunked STFT with per-frame  -> float32 staging file + running
         dB-blended gains                peak (the global peak protect
                                         needs the whole file before any
                                         sample can be finalized)
      then a streaming rescale+quantize copy staging -> PCM_24 output.

    Only the tiny per-frame vectors (levels/states/alpha, ~4 B/frame)
    stay resident. Output matches process_array to float precision.

    checkpoint_path enables chunk-granular crash recovery of pass 3 (the
    expensive one); passes 1-2 are recomputed deterministically on resume.
    Accepts any sr/ch; state CSV as in the reference (:354-362). The
    result's "timings" holds the span totals of each stage (the module's
    docstring), "search_probes" the threshold search's probes and
    "job_id" the call's job id."""
    dev = resolve_device(device)
    p = p or AdaptiveParams()
    job, timings = trace.new_job(), {}
    t_start = time.perf_counter()
    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        n_fft, hop = p.n_fft, p.hop
        pad = n_fft // 2
        min_hold = p.min_hold_frames(sr)
        xfade = p.xfade_frames(sr)

        # ---- pass 1: global input peak -> pre-attenuation ----
        with trace.span("adaptive.peak_scan", timings, "peak_scan_s",
                        job=job):
            atten_db, catt, restore = atten_plan(
                p, scan_input_peak(fin, sr, timings, job))

        k0, F = frame_window(total, n_fft, hop)
        out_path = str(out_path)
        if F == 0:
            # degenerate short file: y = x (ref writes the input back);
            # still write the (header-only) state CSV the caller asked for
            fin.seek(0)
            with trace.span("adaptive.decode", timings, "decode_s",
                            job=job):
                x, _ = audio.read(in_path)
            audio.write(out_path, x, sr, subtype="PCM_24")
            if state_csv_path:
                _write_state_csv(state_csv_path,
                                 dict(n_frames=0, levels=[], states=[],
                                      alpha=[]), hop, sr)
            timings["wall_s"] = round(time.perf_counter() - t_start, 4)
            return dict(n_frames=0, optimal_threshold=0.0, c2_ratio=0.0,
                        switch_count=0, switches_per_min=0.0,
                        short_run_ratio=0.0, atten_db=atten_db,
                        min_hold_frames=min_hold, xfade_frames=xfade,
                        params=asdict(p), sr=sr, total=total,
                        out_path=out_path, device=str(dev),
                        timings=timings, search_probes=0, job_id=job)

        # ---- pass 2: levels -> threshold -> states -> alpha ----
        with trace.span("adaptive.levels", timings, "levels_s", job=job):
            levels = _stream_levels(fin, total, ch, p, catt, device=dev,
                                    acc=timings, job=job)
        plan = gate_plan(levels, p, min_hold, xfade, device=dev, job=job)
        timings.update(plan["timings"])
        run_stats = plan["run_stats"]
        states, alpha = plan["states"], plan["alpha"]

        info = dict(
            n_frames=F,
            optimal_threshold=plan["optimal_t"],
            c2_ratio=run_stats["c2_ratio"],
            switch_count=run_stats["switch_count"],
            switches_per_min=(run_stats["switch_count"]
                              / (total / sr / 60.0)
                              if total > 0 else 0.0),
            short_run_ratio=(plan["short_runs"] / plan["n_runs"]
                             if plan["n_runs"] else 0.0),
            atten_db=atten_db,
            min_hold_frames=min_hold,
            xfade_frames=xfade,
            levels=levels, states=states, alpha=alpha,
            search_probes=plan["search_probes"],
        )
        with trace.span("adaptive.csv", timings, "state_csv_s", job=job):
            if state_csv_path:
                _write_state_csv(state_csv_path, info, hop, sr)

        # ---- pass 3: streaming STFT -> float32 staging + running peak ----
        with trace.span("adaptive.pass3", timings, "pass3_s", job=job):
            engine, controller, chunk_fn = _chunk_step(p, sr, ch, alpha,
                                                       frames_per_chunk, dev)
            ctl_params = controller.params()
            gain_one = torch.ones((), dtype=torch.float32, device=dev)
            base = k0 * hop - pad    # absolute coord of the stream's sample 0

            stage_path = out_path + ".stage.wav"
            ckpt = resume = None
            f0_start = 0
            abs_written = 0          # output samples finalized in staging
            peak = 0.0
            if checkpoint_path:
                # the reference's fingerprint, key for key
                config = dict(asdict(p), sr=sr, ch=ch, total=total,
                              in_path=str(in_path),
                              frames_per_chunk=frames_per_chunk,
                              model="adaptive")
                ckpt = CheckpointManager(checkpoint_path, config,
                                         checkpoint_every)
                resume = ckpt.load()
            if resume is not None and os.path.exists(stage_path):
                sc = resume["__meta__"]["scalars"]
                f0_start = int(sc["f0"])
                abs_written = int(sc["abs_written"])
                peak = float(sc["peak"])
                out_tail = torch.as_tensor(resume["out_tail"], device=dev)
                w_tail = torch.as_tensor(resume["w_tail"], device=dev)
                stage = WavWriter.reopen(stage_path, abs_written)
            else:
                if resume is not None and ckpt is not None:
                    # checkpoint without its stage file: starting fresh. Drop
                    # the stale state NOW, or a crash before the first new
                    # snapshot would resume the old offsets against the new
                    # stage and silently corrupt the output
                    ckpt.clear()
                resume = None
                out_tail, w_tail = engine.zero_tails()
                stage = WavWriter(stage_path, sr, ch, "FLOAT")
            try:
                ctl_carry = torch.full((), f0_start, dtype=torch.int32,
                                       device=dev)
                emitter = StageEmitter(stage, base, total, ch, restore,
                                       abs_written=abs_written, peak=peak)

                def write(f0, stream_lo, piece):
                    with trace.span("adaptive.stage_write", timings,
                                    "stage_write_s", job=job, at=f0):
                        emitter.emit(stream_lo, piece)

                # rolling input: the padded+attenuated stream in xp coords
                read = _decoding(fin.read, timings, job)
                if f0_start == 0:
                    fin.seek(0)
                    reader = RollingReader(read, ch, scale=catt,
                                           left_pad=pad, block=hop * 512)
                else:
                    pos0 = (k0 + f0_start) * hop
                    # k0*hop >= pad, so >= 0
                    fin.seek(min(pos0 - pad, total))
                    reader = RollingReader(read, ch, scale=catt,
                                           block=hop * 512, base=pos0)
                need = engine.chunk_input_len

                for f0 in range(f0_start, F, frames_per_chunk):
                    nf = min(frames_per_chunk, F - f0)
                    s = (k0 + f0) * hop
                    reader.advance(s)
                    if ckpt is not None and f0 > f0_start \
                            and ((f0 - f0_start) // frames_per_chunk) \
                            % ckpt.every == 0:
                        # the loop is in order: every chunk before f0 is in
                        # the stage; data bytes on disk before the state is
                        stage.flush()
                        ckpt.maybe_save(dict(
                            out_tail=_host(out_tail), w_tail=_host(w_tail),
                            __scalars__=dict(f0=f0,
                                             abs_written=emitter.abs_written,
                                             peak=emitter.peak)), force=True)
                    window = np.ascontiguousarray(reader.window(s, need))
                    with trace.span("adaptive.step", timings, "step_s",
                                    job=job, at=f0):
                        emit, _aux, _, ctl_carry, out_tail, w_tail = chunk_fn(
                            torch.from_numpy(window).to(dev), nf, ctl_carry,
                            out_tail, w_tail, ctl_params, gain_one)
                        piece = _host(emit[:nf * hop + engine.tail_len]
                                      if nf < frames_per_chunk
                                      else emit[:nf * hop])
                    write(f0, f0 * hop, piece)
                    if progress is not None:
                        progress(f0 + nf, F)

                if F % frames_per_chunk == 0:
                    write(F, F * hop, _closing_tail(out_tail, w_tail))
                with trace.span("adaptive.stage_write", timings,
                                "stage_write_s", job=job, at=F):
                    emitter.fill_tail()   # uncovered tail region stays zero
            finally:
                stage.close()

        with trace.span("adaptive.finalize", timings, "restore_protect_s",
                        job=job):
            finalize_stage(stage_path, out_path, sr, ch, emitter.peak,
                           timings, job)
            if ckpt is not None:
                ckpt.clear()

    timings["wall_s"] = round(time.perf_counter() - t_start, 4)
    out = {k: v for k, v in info.items()
           if k not in ("levels", "states", "alpha")}
    out.update(params=asdict(p), sr=sr, total=total, out_path=out_path,
               device=str(dev), timings=timings, job_id=job)
    return out
