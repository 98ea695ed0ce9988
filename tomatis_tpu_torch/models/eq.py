"""Layer-2 EQ appliers, PyTorch port of tomatis_tpu/models/eq.py
(capability parity with ref src/layer2_apply_eq.py,
src/layer2b_apply_residual_eq.py, src/layer2b_apply_residual_eq_safe.py).

All three are gate-free STFT gain applications sharing one uncropped
streaming loop (the reference writes the *whole* OLA stream including the
half-window pre-pad and tail: output files are longer than the input by
design; downstream comparators re-align by cross-correlation).

The loop is the stream engine's: a producer thread reads the file (as
PCM_24 ints when no pre-gain multiplies them), the calling thread uploads
and enqueues one chunk step (one launch of the fused chunk-tail kernel on
a CUDA tensor) and moves the chunks through the depth-3 pipeline of
utils/pipeline.py, and an ordered worker thread tracks the peak and
writes the file, so the input's decode and the output's encode overlap
each other and the device. A checkpointed run keeps the writes on the
calling thread and stalls at snapshot boundaries.
"""
from __future__ import annotations

import csv as _csv
import hashlib
import os
import time

import numpy as np
import torch

from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                ChunkReadback, _encode_pcm24,
                                                _host, resolve_transport,
                                                stage_to_device)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.controllers import StaticGainController
from tomatis_tpu_torch.models.standard import (finalize_checkpointed_sink,
                                               open_checkpointed_sink)
from tomatis_tpu_torch.ops.dsp import EPS
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.utils.pipeline import (OrderedWorker, Prefetcher,
                                              StagedPipeline)
from tomatis_tpu_torch.utils.rolling import RollingReader


# ---------------------------------------------------------------------------
# EQ curve construction
# ---------------------------------------------------------------------------

def load_eq_csv(path):
    """Tolerant-column EQ CSV loader (ref src/layer2_apply_eq.py:11-46):
    freq column from {freq_hz,freq,hz,f}; gain column prefers
    delta_db_smooth, then {delta_db,db,gain_db,delta,gain}. Sorted by f."""
    with open(path, "r", encoding="utf-8") as f:
        reader = _csv.DictReader(f)
        cols = [c.lower().strip() for c in reader.fieldnames]

        def pick(cands):
            for c in cands:
                if c in cols:
                    return reader.fieldnames[cols.index(c)]
            return None

        f_col = pick(["freq_hz", "freq", "hz", "f"])
        d_col = pick(["delta_db_smooth", "delta_db", "db", "gain_db",
                      "delta", "gain"])
        if f_col is None or d_col is None:
            raise ValueError(f"unexpected EQ CSV columns: {reader.fieldnames}")
        freqs, dbs = [], []
        for row in reader:
            freqs.append(float(row[f_col]))
            dbs.append(float(row[d_col]))
    freqs = np.asarray(freqs, np.float32)
    dbs = np.asarray(dbs, np.float32)
    idx = np.argsort(freqs)
    return freqs[idx], dbs[idx]


def build_gain_per_bin(sr: int, n_fft: int, eq_freqs, eq_db) -> np.ndarray:
    """Interpolate the (f -> dB) curve onto rFFT bins on the log-f axis with
    edge clamping (ref src/layer2_apply_eq.py:48-64). Returns linear gains."""
    f_bins = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(np.float32)
    x = np.log10(np.maximum(eq_freqs, 1.0))
    xb = np.log10(np.maximum(f_bins, 1.0))
    yb = np.interp(xb, x, eq_db, left=eq_db[0], right=eq_db[-1])
    return (10.0 ** (yb.astype(np.float32) / 20.0)).astype(np.float32)


def smooth_on_logfreq(freq, db, win: int = 21) -> np.ndarray:
    """Moving average on a uniform log-f grid, mapped back
    (ref src/layer2b_apply_residual_eq.py:12-35)."""
    freq = np.asarray(freq, np.float64)
    db = np.asarray(db, np.float64)
    lf = np.log10(np.maximum(freq, 1.0))
    order = np.argsort(lf)
    lf2, db2 = lf[order], db[order]
    n = len(db2)
    grid = np.linspace(lf2.min(), lf2.max(), n)
    dbg = np.interp(grid, lf2, db2)
    win = max(3, win | 1)
    pad = win // 2
    x = np.pad(dbg, (pad, pad), mode="edge")
    y = np.convolve(x, np.ones(win) / win, mode="valid")
    db_smooth = np.interp(lf2, grid, y)
    out = np.empty_like(db_smooth)
    out[order] = db_smooth
    return out


def build_eq_from_residual(freqs_rfft, res_freq, res_db,
                           clamp_lo=-6.0, clamp_hi=6.0,
                           mid_start=3000.0, mid_clamp_hi=2.0,
                           hf_start=8000.0, hf_clamp_hi=0.0):
    """Banded-clamp residual EQ (ref src/layer2b_apply_residual_eq.py:37-55):
    global +-6 dB, [3k, 8k) capped at +2 dB, >=8 kHz capped at 0 dB."""
    db = np.interp(freqs_rfft, res_freq, res_db,
                   left=res_db[0], right=res_db[-1])
    db = np.clip(db, clamp_lo, clamp_hi)
    mid = (freqs_rfft >= mid_start) & (freqs_rfft < hf_start)
    db[mid] = np.clip(db[mid], clamp_lo, mid_clamp_hi)
    hf = freqs_rfft >= hf_start
    db[hf] = np.clip(db[hf], clamp_lo, hf_clamp_hi)
    return (10.0 ** (db / 20.0)).astype(np.float32), db.astype(np.float32)


def build_eq_from_residual_safe(freqs_rfft, res_freq, res_db,
                                clamp_lo=-1.0, clamp_hi=1.0,
                                hf_start=3000.0):
    """Safe-B variant (ref src/layer2b_apply_residual_eq_safe.py:37-51):
    clamp +-1 dB, forced 0 dB above 3 kHz (no noise boost)."""
    db = np.interp(freqs_rfft, res_freq, res_db,
                   left=res_db[0], right=res_db[-1])
    db = np.clip(db, clamp_lo, clamp_hi)
    db[freqs_rfft >= hf_start] = 0.0
    return (10.0 ** (db / 20.0)).astype(np.float32), db.astype(np.float32)


def load_residual_csv(path):
    """diff_spectrum.csv reader (ref src/layer2b_apply_residual_eq.py:77-82):
    freq_hz + delta_db_base_minus_cand (or legacy delta_db)."""
    with open(path, "r", encoding="utf-8", newline="") as f:
        reader = _csv.DictReader(f)
        names = [c.strip() for c in (reader.fieldnames or [])]
        col = ("delta_db_base_minus_cand"
               if "delta_db_base_minus_cand" in names else "delta_db")
        if "freq_hz" not in names or col not in names:
            raise KeyError(f"residual CSV needs freq_hz and {col}: {names}")
        f_key = reader.fieldnames[names.index("freq_hz")]
        d_key = reader.fieldnames[names.index(col)]
        freqs, dbs = [], []
        for row in reader:
            freqs.append(float(row[f_key]))
            dbs.append(float(row[d_key]))
    return np.asarray(freqs, np.float32), np.asarray(dbs, np.float32)


# ---------------------------------------------------------------------------
# The shared uncropped streaming applier
# ---------------------------------------------------------------------------

def apply_gain_stream(in_path, out_path, gain_bins: np.ndarray,
                      n_fft: int = 4096, hop: int = 2048,
                      pad_len: int = 0, pre_gain: float = 1.0,
                      frames_per_chunk: int = 1024,
                      require_48k_stereo: bool = True,
                      checkpoint_path=None, checkpoint_every: int = 8,
                      progress=None, device="cuda") -> dict:
    """Stream in -> per-bin gain -> OLA -> out, uncropped (the output length
    is the last frame's end; includes the pre-pad: reference behavior).
    Returns dict(peak_seen, out_path, n_frames, sr, transport, timings).

    The transport follows the sink, through the engine's
    resolve_transport("auto", ...): PCM_24 packed on the device when the
    sink takes raw bytes (every PCM_24 sink does), floats read back
    otherwise.
    peak_seen comes from the kernel's per-hop-block peaks (pcm24) or from
    the floats (f32).

    checkpoint_path enables chunk-granular crash recovery (same scheme as
    the standard processor): the tiny stream state (OLA tails, peak, next
    chunk index) persists every checkpoint_every chunks; re-running the
    same call resumes. Non-WAV outputs stage through a .part WAV.

    progress(frames_done, frames_total) is invoked per chunk in stream
    order, on the worker thread that writes the file (on the calling
    thread in a checkpointed run). A progress exception fails the run.
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        if require_48k_stereo:
            if sr != 48000:
                raise ValueError(f"expected 48kHz, got {sr}")
            if ch != 2:
                raise ValueError(f"expected stereo, got {ch} channels")
        padded = total + 2 * pad_len
        F = max(0, (padded - n_fft) // hop + 1)

        out_path = str(out_path)
        f0_start = 0
        config = None
        if checkpoint_path:
            # the reference's fingerprint, key for key: the state holds no
            # encoded output, so the transport is not part of it
            gb = np.asarray(gain_bins, np.float32)
            config = dict(model="eq_gain_stream", in_path=str(in_path),
                          sr=sr, ch=ch, total=total, n_fft=n_fft, hop=hop,
                          pad_len=pad_len, pre_gain=float(pre_gain),
                          frames_per_chunk=frames_per_chunk,
                          gain_sha=hashlib.sha256(gb.tobytes()).hexdigest())
        # one home for the sink semantics (WAV-fallback hint, staged WAV,
        # stale-checkpoint clear): the standard processor's helper
        fout, actual_out, ckpt, resume, stage_path = open_checkpointed_sink(
            out_path, sr, ch, config, checkpoint_path, checkpoint_every)
        try:
            # "auto" on the port is pcm24 on a raw sink, f32 otherwise
            transport, raw = resolve_transport("auto", fout.supports_raw)
            engine = ChunkedStftEngine(n_fft, hop, ch, frames_per_chunk,
                                       device=dev)
            controller = StaticGainController(gain_bins).to(dev)
            chunk_fn = engine.make_chunk_fn(controller, transport=transport)
            ctl_params = controller.params()
            gain_one = torch.ones((), dtype=torch.float32, device=dev)

            ctl_carry = controller.init_carry()
            out_tail, w_tail = engine.zero_tails()
            need = engine.chunk_input_len
            # float-free input when no pre-gain multiply is needed and the
            # source reads losslessly as PCM_24 ints (mirrors the engine):
            # the ints are uploaded and scaled on the device
            int_in = pre_gain == 1.0 and fin.int24_readable
            scale = (np.float32(pre_gain)
                     if not int_in and pre_gain != 1.0 else None)
            peak_seen = 0.0
            lead, pos = pad_len, 0
            if resume is not None:
                sc = resume["__meta__"]["scalars"]
                f0_start = int(sc["next_f0"])
                peak_seen = float(sc["peak_seen"])
                out_tail = torch.as_tensor(resume["out_tail"], device=dev)
                w_tail = torch.as_tensor(resume["w_tail"], device=dev)
                # reposition the padded input stream at sample f0_start*hop
                pos = f0_start * hop
                lead = max(0, pad_len - pos)
                if pos > pad_len:
                    fin.seek(pos - pad_len)
            # padded input stream in RollingReader coords (0 = first pad
            # zero)
            reader = RollingReader(fin.read_int24 if int_in else fin.read,
                                   ch, dtype=np.int32 if int_in
                                   else np.float32,
                                   scale=scale, left_pad=lead, base=pos,
                                   block=engine.emit_len)

            def write_piece(piece, pk):
                nonlocal peak_seen
                peak_seen = max(peak_seen, pk)
                if raw:
                    fout.write_raw(piece)
                else:
                    fout.write(piece)

            def consume_host(ready, mat):
                """Worker-thread half: peak track + file write."""
                _f0, c_nf, _rb = ready
                emit_n = c_nf * hop + (engine.tail_len
                                       if c_nf < frames_per_chunk else 0)
                payload, aux = mat
                if raw:
                    piece = payload[:emit_n * ch * 3]
                    pk = (float(np.max(aux[-1][:emit_n // hop]))
                          if emit_n else 0.0)
                else:
                    piece = payload[:emit_n]
                    pk = float(np.max(np.abs(piece))) if emit_n else 0.0
                write_piece(piece, pk)

            def produce(f0):
                for f in range(f0, F, frames_per_chunk):
                    yield reader.window(f * hop, need)
                    if f + frames_per_chunk < F:
                        reader.advance((f + frames_per_chunk) * hop)

            # host wall time of the calling thread per stage: input
            # (producer wait + upload), dispatch (chunk step enqueue and
            # the pipeline's S1/S2), consume (the S3 waits and the
            # writer's back-pressure; with a checkpoint the writes
            # themselves)
            timings = {"input_host_s": 0.0, "dispatch_compute_s": 0.0,
                       "consume_s": 0.0}
            chunks = 0
            # file read prefetch on a producer thread; depth-3 staged
            # chunk pipeline (the engine's); peak + write on an ordered
            # worker (`progress` then runs on the worker thread).
            # Checkpointed runs keep the write side synchronous and stall
            # at snapshot boundaries: maybe_save must observe every prior
            # chunk on disk.
            writer_w = OrderedWorker() if ckpt is None else None
            prefetch = Prefetcher(produce(f0_start))

            def next_staged():
                return stage_to_device(prefetch.get(), dev)

            def pipe_finish(ck):
                mat = ck["ready"][2].materialize()

                def job(iv=ck["ready"], m=mat):
                    consume_host(iv, m)
                    if progress is not None:
                        # frames COMPLETED (start + count), so the last
                        # call reports F/F like the standard processor
                        progress(iv[0] + iv[1], F)
                if writer_w is not None:
                    writer_w.submit(job)
                else:
                    job()

            pipe = StagedPipeline(lambda ck: None, pipe_finish)
            try:
                staged = None
                for f0 in range(f0_start, F, frames_per_chunk):
                    nf = min(frames_per_chunk, F - f0)
                    if ckpt is not None and f0 > f0_start \
                            and ((f0 - f0_start) // frames_per_chunk) \
                            % ckpt.every == 0:
                        # checkpoint boundary: every chunk before f0 must
                        # be written before the pre-dispatch tails are
                        # persisted (resuming at f0 needs the tails as
                        # they are NOW)
                        t0 = time.perf_counter()
                        pipe.drain()
                        timings["consume_s"] += time.perf_counter() - t0
                        ckpt.maybe_save(dict(
                            out_tail=_host(out_tail), w_tail=_host(w_tail),
                            __scalars__=dict(
                                next_f0=f0, peak_seen=peak_seen,
                                audio_samples_written=f0 * hop)),
                            force=True)
                    t0 = time.perf_counter()
                    if staged is None:
                        staged = next_staged()
                    t1 = time.perf_counter()
                    payload, aux, _out, ctl_carry, out_tail, w_tail = \
                        chunk_fn(staged, nf, ctl_carry, out_tail, w_tail,
                                 ctl_params, gain_one)
                    rb = ChunkReadback([payload, aux])
                    pipe.push((f0, nf, rb), rb)
                    pipe.promote()
                    t2 = time.perf_counter()
                    # stage the next chunk's input while the device works
                    staged = None
                    if f0 + frames_per_chunk < F:
                        staged = next_staged()
                    t3 = time.perf_counter()
                    pipe.retire()
                    timings["input_host_s"] += (t1 - t0) + (t3 - t2)
                    timings["dispatch_compute_s"] += t2 - t1
                    timings["consume_s"] += time.perf_counter() - t3
                    chunks += 1
                t0 = time.perf_counter()
                pipe.drain()
                if writer_w is not None:
                    writer_w.check(join=True)
                timings["consume_s"] += time.perf_counter() - t0
            finally:
                prefetch.close()
                if writer_w is not None:
                    writer_w.close()

            if F > 0 and F % frames_per_chunk == 0:
                # after a final FULL chunk the carry still holds the
                # stream's tail
                tail = _host(out_tail) / (_host(w_tail)[:, None] + EPS)
                pk = float(np.max(np.abs(tail))) if tail.size else 0.0
                write_piece(_encode_pcm24(tail) if raw else tail, pk)
        finally:
            # fout must close (fixing the WAV header) even if the run dies
            # mid-stream: resume parses the frame count from that header
            fout.close()
        t_fin = time.perf_counter()
        actual_out = (finalize_checkpointed_sink(ckpt, stage_path, out_path)
                      or actual_out)
    now = time.perf_counter()
    timings = {k: round(v, 4) for k, v in timings.items()}
    timings["finalize_s"] = round(now - t_fin, 4)
    timings["wall_s"] = round(now - t_start, 4)
    return dict(peak_seen=peak_seen, out_path=actual_out, n_frames=F, sr=sr,
                transport=transport, chunks=chunks, device=str(dev),
                timings=timings)


# ---------------------------------------------------------------------------
# User-facing appliers
# ---------------------------------------------------------------------------

def apply_eq(in_path, out_path, eq_csv, n_fft=4096, hop=2048, pad=True,
             global_gain_db=0.0, auto_gain_protect=True, peak_target=0.99,
             frames_per_chunk: int = 1024,
             checkpoint_path=None, checkpoint_every: int = 8,
             progress=None, device="cuda") -> dict:
    """Layer-2 static EQ (ref src/layer2_apply_eq.py:66-233): log-f interp,
    optional input gain, two-pass gain protect writing an extra *_gp file
    when the streamed peak exceeds peak_target."""
    meta = audio.info(in_path)
    eq_freqs, eq_db = load_eq_csv(eq_csv)
    gain_bins = build_gain_per_bin(meta.samplerate, n_fft, eq_freqs, eq_db)
    res = apply_gain_stream(
        in_path, out_path, gain_bins, n_fft, hop,
        pad_len=n_fft // 2 if pad else 0,
        pre_gain=float(10.0 ** (global_gain_db / 20.0)),
        frames_per_chunk=frames_per_chunk,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        progress=progress, device=device)
    res["gain_protected_path"] = None
    if auto_gain_protect and res["peak_seen"] > peak_target:
        t0 = time.perf_counter()
        scale = peak_target / max(res["peak_seen"], 1e-12)
        src = res["out_path"]
        root, ext = os.path.splitext(src)   # not rsplit('.'): a dot in
        gp = f"{root}_gp{ext}"              # a parent dir must not split
        with audio.AudioFile(src, "r") as fin, \
                audio.AudioFile(gp, "w", samplerate=fin.samplerate,
                                channels=fin.channels,
                                subtype="PCM_24") as fgp:
            while True:
                x = fin.read(48000 * 30)
                if len(x) == 0:
                    break
                fgp.write((x * scale).astype(np.float32))
        res["gain_protected_path"] = gp
        res["gain_protect_scale"] = scale
        res["timings"]["gain_protect_s"] = round(time.perf_counter() - t0, 4)
    return res


def apply_residual_eq(in_audio, out_audio, diff_csv, n_fft=4096, hop=2048,
                      smooth_win=None, clamp_hi=None, mid_start=3000.0,
                      mid_clamp_hi=2.0, hf_start=None, hf_clamp_hi=0.0,
                      safe: bool = False, frames_per_chunk: int = 1024,
                      pre_gain_db: float = 0.0,
                      checkpoint_path=None, checkpoint_every: int = 8,
                      device="cuda") -> dict:
    """Layer-2b residual EQ applier; safe=True selects the Safe-B variant.

    smooth_win / clamp_hi / hf_start default PER MODE (None): standard
    41 / +6 dB / 8 kHz (ref layer2b_apply_residual_eq.py:37-55), Safe-B
    61 / +1 dB / 3 kHz (ref layer2b_apply_residual_eq_safe.py:37-51),
    so safe=True alone yields the actual Safe-B clamps; callers only
    override explicitly.
    pre_gain_db scales the input before EQ: 0.0 matches the reference
    appliers (which write raw and can clip in PCM); the automated workflow
    uses it for a two-pass peak protect."""
    if smooth_win is None:
        smooth_win = 61 if safe else 41
    if clamp_hi is None:
        clamp_hi = 1.0 if safe else 6.0
    if hf_start is None:
        hf_start = 3000.0 if safe else 8000.0
    res_freq, res_db = load_residual_csv(diff_csv)
    res_db_s = smooth_on_logfreq(res_freq, res_db, win=smooth_win)
    meta = audio.info(in_audio)
    if meta.channels != 2:
        raise ValueError("stereo required")
    freqs = np.fft.rfftfreq(n_fft, 1.0 / meta.samplerate)
    if safe:
        eq_lin, eq_db = build_eq_from_residual_safe(
            freqs, res_freq, res_db_s, clamp_lo=-1.0, clamp_hi=clamp_hi,
            hf_start=hf_start)
    else:
        eq_lin, eq_db = build_eq_from_residual(
            freqs, res_freq, res_db_s, clamp_lo=-6.0, clamp_hi=clamp_hi,
            mid_start=mid_start, mid_clamp_hi=mid_clamp_hi,
            hf_start=hf_start, hf_clamp_hi=hf_clamp_hi)
    # no padding in the reference residual appliers
    out = apply_gain_stream(in_audio, out_audio, eq_lin, n_fft, hop,
                            pad_len=0, frames_per_chunk=frames_per_chunk,
                            pre_gain=float(10.0 ** (pre_gain_db / 20.0)),
                            require_48k_stereo=False,
                            checkpoint_path=checkpoint_path,
                            checkpoint_every=checkpoint_every, device=device)
    out["eq_db"] = eq_db
    return out
