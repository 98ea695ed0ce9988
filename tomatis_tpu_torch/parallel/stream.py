"""File-to-file processing over a ('data', 'seq') device mesh, PyTorch port
of tomatis_tpu/parallel/stream.py.

This is the user-facing driver of parallel.sharded (CLI `process-sharded`):
one file's frames are split across the 'seq' shards of the mesh, the gate
automaton crosses shards as a block-composed scan, and the OLA halo rides
one copy per shard boundary, while the host streams super-chunks of
n_seq * frames_per_shard frames with carried gate state (and crossfade
alpha) and OLA tails, and writes the output with the exact single-device
semantics (flush plan, per-flush peak clamp, state CSV).

On one card a mesh of repeated devices (devices=[cuda:0]*n) runs every
shard there: the halo and the gathered totals are same-device copies. On
several cards the same code spreads one file's FFT bank over them.

Variants: "standard" (hysteresis + up-delay gate) and "xfade" (the same
gate plus the rate-limited alpha ramp with dB-domain gain blending);
process_sharded_adaptive runs the adaptive processor's three passes with
its heavy STFT pass sharded.
"""
from __future__ import annotations

import os
import time
from dataclasses import asdict

import numpy as np
import torch

from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                StreamRunner, _host,
                                                flush_plan)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.io.wav import WavWriter
from tomatis_tpu_torch.models import adaptive as _adaptive
from tomatis_tpu_torch.models import standard as _standard
from tomatis_tpu_torch.models import xfade as _xfade
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
from tomatis_tpu_torch.ops.cuda_ola import FLOOR8
from tomatis_tpu_torch.ops.dsp import EPS
from tomatis_tpu_torch.parallel.sharded import (make_mesh,
                                                sharded_adaptive_stream_step,
                                                sharded_stream_step,
                                                sharded_xfade_stream_step)
from tomatis_tpu_torch.utils.rolling import RollingReader
from tomatis_tpu_torch.utils.stateio import StateCsvWriter


def _frames_on(sig: np.ndarray, dev, n_fft: int, hop: int, n_frames: int):
    """A host window [S, C] uploaded once and framed on dev: [1, F, C,
    n_fft]."""
    t = torch.from_numpy(np.ascontiguousarray(sig, np.float32)).to(dev)
    return stft.frame_signal(t, n_fft, hop, n_frames)[None]


def process_sharded(in_path, out_path, p=None,
                    n_devices: int | None = None, data: int = 1,
                    frames_per_shard: int = 256,
                    state_csv_path=None, variant: str = "standard",
                    checkpoint_path=None, checkpoint_every: int = 8,
                    devices=None) -> dict:
    """Standard/crossfade processing of ONE file sharded over a mesh.

    p: StandardParams (variant="standard") or XfadeParams ("xfade").
    devices: an explicit device list (repeats allowed: [cuda:0]*4 is four
    shards on one card, [cpu]*8 eight on the CPU); otherwise the first
    n_devices CUDA devices (all by default; raises without a card).
    data must be 1: this driver processes ONE file, so every device
    belongs on the 'seq' axis. For parallelism across files use
    parallel.batch.process_batch (CLI `process-batch --devices N`).

    The standard variant writes the single-device engine's bytes. The
    xfade variant matches within 1 PCM_24 LSB on ramp frames: the
    block-composed alpha scan reassociates f32 clip-affine maps, which can
    move mid-ramp gains by one ulp.

    checkpoint_path enables super-chunk-granular crash recovery with the
    single-device engine's byte-identical-resume guarantee: the sequential
    state (gate carry, xfade alpha, OLA tails, undrained output, flush
    cursor) is persisted every checkpoint_every super-chunks; re-running
    the same call resumes at the last snapshot. The mesh geometry (n_seq,
    frames_per_shard) is part of the checkpoint fingerprint: resuming on
    another mesh is refused rather than risking a reassociated-scan
    divergence.
    """
    t_start = time.perf_counter()
    if variant not in ("standard", "xfade"):
        raise ValueError(variant)
    if data != 1:
        raise ValueError(
            "process_sharded runs ONE file with all devices on the 'seq' "
            "axis; data must be 1 (use process-batch for file "
            f"parallelism), got data={data}")
    xf = variant == "xfade"
    if p is None:
        p = _xfade.XfadeParams() if xf else _standard.StandardParams()
    mesh = make_mesh(n_devices=n_devices, data=data, devices=devices)
    dev = mesh.first
    n_seq = mesh.shape["seq"]
    n_fft, hop = p.n_fft, p.hop
    tail = n_fft - hop
    F_tot = frames_per_shard * n_seq
    timings = dict(read_s=0.0, step_s=0.0, write_s=0.0)

    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        if p.require_48k_stereo:
            if sr != 48000:
                raise ValueError(f"expected 48kHz, got {sr} Hz")
            if ch != 2:
                raise ValueError(f"expected stereo, got {ch} channels")

        freqs = stft.rfft_freqs(n_fft, sr)
        g1_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c1_low,
                                       p.c1_high)
        g2_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c2_low,
                                       p.c2_high)
        T = p.threshold_dbfs()
        ton = T + p.hysteresis_db / 2.0
        toff = T - p.hysteresis_db / 2.0
        delay_frames = gate_ops.updelay_frames(
            int(sr * p.up_delay_ms / 1000.0), hop)
        if xf:
            xff = p.xfade_frames(sr)
            alpha_step = 1.0 / xff if xff > 0 else 1.0
            step = sharded_xfade_stream_step(
                mesh, n_fft, hop, frames_per_shard, ch, ton=ton,
                toff=toff, delay_frames=delay_frames,
                alpha_step=alpha_step, g1_db=g1_db, g2_db=g2_db)
        else:
            step = sharded_stream_step(
                mesh, n_fft, hop, frames_per_shard, ch, ton=ton,
                toff=toff, delay_frames=delay_frames,
                g1_lin=dsp.db_to_lin(g1_db).numpy(),
                g2_lin=dsp.db_to_lin(g2_db).numpy())

        plan = flush_plan(total, n_fft, hop)
        pad, n_frames = plan.pad, plan.n_frames

        out_path = str(out_path)
        config = dict(asdict(p), sr=sr, ch=ch, total=total,
                      in_path=str(in_path), n_seq=n_seq,
                      frames_per_shard=frames_per_shard,
                      model=f"sharded-{variant}")
        (fout, actual_out, ckpt, resume_state,
         stage_path) = _standard.open_checkpointed_sink(
            out_path, sr, ch, config, checkpoint_path, checkpoint_every)
        resume_frame = None
        if resume_state is not None:
            resume_frame = int(resume_state["__meta__"]["scalars"]
                               ["frames_consumed"])
        if xf:
            csvw = StateCsvWriter(state_csv_path, sr, total,
                                  with_alpha=True, level_fmt="%.2f",
                                  alpha_fmt="%.3f",
                                  resume_at_frame=resume_frame) \
                if state_csv_path else None
            controller = _xfade.build_controller(p, sr, "cpu")
            output_gain_db = 0.0
        else:
            csvw = StateCsvWriter(state_csv_path, sr, total,
                                  resume_at_frame=resume_frame) \
                if state_csv_path else None
            controller = _standard.build_controller(p, sr, "cpu")
            output_gain_db = p.output_gain_db

        # drain/clamp reuse: a chunk-fn-less StreamRunner provides the
        # reference write-out semantics (flush cuts + per-flush clamp)
        engine = ChunkedStftEngine(n_fft, hop, ch, frames_per_chunk=F_tot,
                                   device="cpu")
        runner = StreamRunner(engine, controller, total,
                              output_gain_db=output_gain_db,
                              transport="f32", build_chunk_fn=False)

        states_count = np.zeros(3, np.int64)
        out_pend: list = []
        cut_i = 0
        out_base = -pad
        carry = torch.zeros((1,), dtype=torch.int32, device=dev)
        alpha_c = torch.zeros((1,), dtype=torch.float32, device=dev)
        in_ty = torch.zeros((1, tail, ch), dtype=torch.float32, device=dev)
        in_tw = torch.zeros((1, tail), dtype=torch.float32, device=dev)
        f0_start = 0
        written = [0]   # samples written to the sink (checkpoint scalar)

        if resume_state is not None:
            sc = resume_state["__meta__"]["scalars"]
            f0_start = int(sc["frame0"])
            cut_i = int(sc["cut_i"])
            out_base = int(sc["out_base"])
            written[0] = int(sc["audio_samples_written"])
            states_count = resume_state["states_count"].astype(np.int64)
            carry = torch.as_tensor(resume_state["gate_carry"], device=dev)
            alpha_c = torch.as_tensor(resume_state["alpha_carry"],
                                      device=dev)
            in_ty = torch.as_tensor(resume_state["in_ty"], device=dev)
            in_tw = torch.as_tensor(resume_state["in_tw"], device=dev)
            if resume_state["out_pend"].size:
                out_pend = [resume_state["out_pend"]]

        def write_counted(blk):
            written[0] += len(blk)
            fout.write(blk)

        def save_snapshot(next_f0):
            state = dict(
                gate_carry=_host(carry), alpha_carry=_host(alpha_c),
                in_ty=_host(in_ty), in_tw=_host(in_tw),
                out_pend=(np.concatenate(out_pend, 0) if out_pend
                          else np.zeros((0, ch), np.float32)),
                states_count=states_count)
            state["__scalars__"] = dict(
                frame0=int(next_f0), out_base=int(out_base),
                cut_i=int(cut_i),
                audio_samples_written=int(written[0]),
                frames_consumed=int(next_f0))
            ckpt.maybe_save(state)

        # padded-coordinate input stream (coord c = abs c - pad, so the
        # first file sample sits at coord `pad`); a resumed run seeks the
        # source to the snapshot frame instead of re-reading the
        # already-processed span
        s_file = f0_start * hop - pad
        if s_file > 0:
            fin.seek(s_file)
        reader = RollingReader(fin.read, ch, left_pad=max(0, -s_file),
                               base=f0_start * hop, block=hop * 512)
        need = (F_tot - 1) * hop + n_fft

        try:
            for f0 in range(f0_start, max(n_frames, 0), F_tot):
                t0 = time.perf_counter()
                nf = min(F_tot, n_frames - f0)
                sig = reader.window(f0 * hop, need)
                t1 = time.perf_counter()
                frames = _frames_on(sig, dev, n_fft, hop, F_tot)
                nv = torch.full((1,), nf, dtype=torch.int32, device=dev)
                if xf:
                    (emit, levels, states, alpha, carry, alpha_c,
                     oty, otw) = step(frames, carry, alpha_c, nv, in_ty,
                                      in_tw)
                    alpha_np = _host(alpha[0])[:nf]
                else:
                    emit, levels, states, carry, oty, otw = step(
                        frames, carry, nv, in_ty, in_tw)
                    alpha_np = None
                emit_np = _host(emit[0])
                lv = _host(levels[0])[:nf]
                st = _host(states[0])[:nf].astype(np.int32)
                t2 = time.perf_counter()
                states_count[1] += int(np.sum(st == 1))
                states_count[2] += int(np.sum(st == 2))
                if csvw is not None:
                    starts = -pad + (f0 + np.arange(nf)) * hop
                    log = {"levels": lv, "states": st}
                    if alpha_np is not None:
                        log["alpha"] = alpha_np
                    csvw.on_frames(f0, starts, log)
                last = f0 + nf >= n_frames
                if not last:
                    out_pend.append(emit_np)
                    in_ty = oty[:, -tail:]
                    in_tw = otw[:, -tail:]
                else:
                    wanted = nf * hop + tail
                    if wanted <= F_tot * hop:
                        out_pend.append(emit_np[:wanted])
                    else:
                        t_y = _host(oty[0, -tail:])
                        t_w = _host(otw[0, -tail:])
                        out_pend.append(emit_np)
                        out_pend.append(
                            (t_y / (t_w[:, None] + EPS))
                            [:wanted - F_tot * hop])
                cut_i, out_base = runner._drain(out_pend, [], [], cut_i,
                                                out_base, last,
                                                write_counted)
                # pop the consumed input window (keep the n_fft-hop overlap)
                reader.advance((f0 + nf) * hop)
                if ckpt is not None and not last:
                    save_snapshot(f0 + F_tot)
                t3 = time.perf_counter()
                timings["read_s"] += t1 - t0
                timings["step_s"] += t2 - t1
                timings["write_s"] += t3 - t2
        finally:
            # close the sink even when a step fails mid-stream
            # (the WAV header length is fixed on close)
            fout.close()
            if csvw:
                csvw.close()
        actual_out = (_standard.finalize_checkpointed_sink(
            ckpt, stage_path, out_path) or actual_out)

    wall = time.perf_counter() - t_start
    total_f = int(states_count[1] + states_count[2])
    return dict(
        n_frames=max(n_frames, 0),
        c1_frames=int(states_count[1]), c2_frames=int(states_count[2]),
        c1_ratio=states_count[1] / total_f if total_f else 0.0,
        c2_ratio=states_count[2] / total_f if total_f else 0.0,
        mesh=dict(mesh.shape), frames_per_shard=frames_per_shard,
        variant=variant, sr=sr, channels=ch, total=total,
        out_path=actual_out, threshold_dbfs=p.threshold_dbfs(),
        wall_seconds=wall,
        realtime_factor=(total / sr) / wall if wall > 0 else 0.0,
        timings={k: round(v, 4) for k, v in timings.items()})


def process_sharded_adaptive(in_path, out_path, p=None,
                             n_devices: int | None = None,
                             frames_per_shard: int = 256,
                             state_csv_path=None,
                             checkpoint_path=None,
                             checkpoint_every: int = 8,
                             devices=None) -> dict:
    """Adaptive processing of ONE file sharded over a ('data', 'seq') mesh.

    The three-pass structure of models.adaptive.process is kept: global
    peak -> pre-attenuation, streamed levels -> threshold search -> host
    gate/alpha (state CSV), then the heavy STFT pass runs as sharded
    super-chunks (min-hold gate + snap-first alpha recomputed on the
    devices as block scans, equal to the host pass), staged to a float WAV
    and finalized with the global peak protect (ref
    src/process_tomatis_adaptive.py:201-345). Passes 1-2 run on the mesh's
    first device. Output matches the single-device adaptive processor
    within 1 PCM_24 LSB (the alpha block scan reassociates f32
    clip-affine maps).

    devices / n_devices: as process_sharded's. checkpoint_path enables
    super-chunk-granular crash recovery of pass 3 (the expensive one), as
    the single-device adaptive: passes 1-2 are recomputed on resume, the
    float staging WAV is truncated to the snapshot cursor and appended to,
    and the mesh geometry (n_seq, frames_per_shard) is part of the
    checkpoint fingerprint."""
    t_start = time.perf_counter()
    p = p or _adaptive.AdaptiveParams()
    mesh = make_mesh(n_devices=n_devices, data=1, devices=devices)
    dev = mesh.first
    n_seq = mesh.shape["seq"]
    n_fft, hop = p.n_fft, p.hop
    pad = n_fft // 2
    tail = n_fft - hop
    F_tot = frames_per_shard * n_seq
    out_path = str(out_path)

    with audio.AudioFile(in_path, "r") as fin:
        sr, ch, total = fin.samplerate, fin.channels, fin.frames
        min_hold = p.min_hold_frames(sr)
        xfade = p.xfade_frames(sr)

        # ---- pass 1: global input peak -> pre-attenuation ----
        atten_db, catt, restore = _adaptive.atten_plan(
            p, _adaptive.scan_input_peak(fin, sr))

        k0, F = _adaptive.frame_window(total, n_fft, hop)
        if F == 0:
            fin.seek(0)
            x, _ = audio.read(in_path)
            audio.write(out_path, x, sr, subtype="PCM_24")
            if state_csv_path:
                _adaptive._write_state_csv(
                    state_csv_path, dict(n_frames=0, levels=[], states=[],
                                         alpha=[]), hop, sr)
            return dict(n_frames=0, optimal_threshold=0.0, c2_ratio=0.0,
                        switch_count=0, switches_per_min=0.0,
                        short_run_ratio=0.0, atten_db=atten_db,
                        min_hold_frames=min_hold, xfade_frames=xfade,
                        mesh=dict(mesh.shape),
                        frames_per_shard=frames_per_shard,
                        variant="adaptive", params=asdict(p), sr=sr,
                        total=total, out_path=out_path,
                        wall_seconds=time.perf_counter() - t_start,
                        realtime_factor=0.0)

        # ---- pass 2: levels -> threshold -> host gate/alpha (CSV) ----
        # (shared plan with models/adaptive: same math, same vectors)
        levels = _adaptive._stream_levels(fin, total, ch, p, catt,
                                          device=dev)
        plan = _adaptive.gate_plan(levels, p, min_hold, xfade, device=dev)
        optimal_t, astep = plan["optimal_t"], plan["astep"]
        run_stats = plan["run_stats"]
        if state_csv_path:
            _adaptive._write_state_csv(
                state_csv_path,
                dict(n_frames=F, levels=levels, states=plan["states"],
                     alpha=plan["alpha"]),
                hop, sr)

        # ---- pass 3: sharded streaming STFT -> float staging + peak ----
        freqs = stft.rfft_freqs(n_fft, sr)
        g1_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c1_low,
                                       p.c1_high)
        g2_db = dsp.build_tilt_gain_db(freqs, p.fc, p.slope, p.c2_low,
                                       p.c2_high)
        step = sharded_adaptive_stream_step(
            mesh, n_fft, hop, frames_per_shard, ch,
            ton=optimal_t + p.hyst_db / 2.0,
            toff=optimal_t - p.hyst_db / 2.0,
            min_hold_frames=min_hold, alpha_step=astep,
            g1_db=g1_db, g2_db=g2_db)
        base = k0 * hop - pad

        stage_path = out_path + ".stage.wav"
        ckpt = resume = None
        f0_start = 0
        abs_written = 0
        peak = 0.0
        if checkpoint_path:
            config = dict(asdict(p), sr=sr, ch=ch, total=total,
                          in_path=str(in_path), n_seq=n_seq,
                          frames_per_shard=frames_per_shard,
                          model="sharded-adaptive")
            ckpt = CheckpointManager(checkpoint_path, config,
                                     checkpoint_every)
            resume = ckpt.load()
        if resume is not None and os.path.exists(stage_path):
            sc = resume["__meta__"]["scalars"]
            f0_start = int(sc["f0"])
            abs_written = int(sc["abs_written"])
            peak = float(sc["peak"])
            carry = torch.as_tensor(resume["gate_carry"], device=dev)
            alpha_c = torch.as_tensor(resume["alpha_carry"], device=dev)
            in_ty = torch.as_tensor(resume["in_ty"], device=dev)
            in_tw = torch.as_tensor(resume["in_tw"], device=dev)
            stage = WavWriter.reopen(stage_path, abs_written)
        else:
            if resume is not None and ckpt is not None:
                # checkpoint without its stage file: starting fresh. Drop
                # the stale state NOW, or a crash before the first new
                # snapshot would resume the old offsets against the new
                # stage and silently corrupt the output
                ckpt.clear()
            resume = None
            # h = H: the gate may switch at once; alpha -1: snap-first
            carry = torch.full((1,), min_hold, dtype=torch.int32,
                               device=dev)
            alpha_c = torch.full((1,), -1.0, dtype=torch.float32,
                                 device=dev)
            in_ty = torch.zeros((1, tail, ch), dtype=torch.float32,
                                device=dev)
            in_tw = torch.zeros((1, tail), dtype=torch.float32, device=dev)
            stage = WavWriter(stage_path, sr, ch, "FLOAT")
        emitter = _adaptive.StageEmitter(stage, base, total, ch, restore,
                                         abs_written=abs_written, peak=peak)
        emit_piece = emitter.emit

        if f0_start == 0:
            fin.seek(0)
            reader = RollingReader(fin.read, ch, scale=catt, left_pad=pad,
                                   block=hop * 512)
        else:
            pos0 = (k0 + f0_start) * hop
            fin.seek(min(pos0 - pad, total))  # k0*hop >= pad, so >= 0
            reader = RollingReader(fin.read, ch, scale=catt,
                                   block=hop * 512, base=pos0)
        need = (F_tot - 1) * hop + n_fft
        try:
            for f0 in range(f0_start, F, F_tot):
                nf = min(F_tot, F - f0)
                s = (k0 + f0) * hop
                reader.advance(s)
                if (ckpt is not None and f0 > f0_start
                        and ((f0 - f0_start) // F_tot) % ckpt.every == 0):
                    # state ENTERING super-chunk f0: the synchronous loop
                    # has already emitted every piece before f0, so the
                    # emitter cursor and the carries are consistent here
                    stage.flush()  # data bytes on disk before the state
                    ckpt.maybe_save(dict(
                        gate_carry=_host(carry), alpha_carry=_host(alpha_c),
                        in_ty=_host(in_ty), in_tw=_host(in_tw),
                        __scalars__=dict(
                            f0=int(f0),
                            abs_written=int(emitter.abs_written),
                            peak=float(emitter.peak))), force=True)
                frames = _frames_on(reader.window(s, need), dev, n_fft, hop,
                                    F_tot)
                nv = torch.full((1,), nf, dtype=torch.int32, device=dev)
                (emit, _lv, _st, _al, carry, alpha_c, oty, otw) = step(
                    frames, carry, alpha_c, nv, in_ty, in_tw)
                emit_np = _host(emit[0])
                last = f0 + nf >= F
                if not last:
                    emit_piece(f0 * hop, emit_np)
                    in_ty = oty[:, -tail:]
                    in_tw = otw[:, -tail:]
                else:
                    wanted = nf * hop + tail
                    if wanted <= F_tot * hop:
                        emit_piece(f0 * hop, emit_np[:wanted])
                    else:
                        t_y = _host(oty[0, -tail:])
                        t_w = _host(otw[0, -tail:])
                        emit_piece(f0 * hop, emit_np)
                        emit_piece(f0 * hop + F_tot * hop,
                                   (t_y / np.maximum(t_w[:, None],
                                                     np.float32(FLOOR8)))
                                   [:wanted - F_tot * hop])
            emitter.fill_tail()   # uncovered tail region stays zero
        finally:
            stage.close()

        # ---- finalize: global peak protect + quantize to PCM_24 ----
        _adaptive.finalize_stage(stage_path, out_path, sr, ch, emitter.peak)
        if ckpt is not None:
            ckpt.clear()

    wall = time.perf_counter() - t_start
    return dict(
        n_frames=F,
        optimal_threshold=float(optimal_t),
        c2_ratio=run_stats["c2_ratio"],
        switch_count=run_stats["switch_count"],
        switches_per_min=(run_stats["switch_count"] / (total / sr / 60.0)
                          if total > 0 else 0.0),
        short_run_ratio=(plan["short_runs"] / plan["n_runs"]
                         if plan["n_runs"] else 0.0),
        atten_db=atten_db, min_hold_frames=min_hold, xfade_frames=xfade,
        mesh=dict(mesh.shape), frames_per_shard=frames_per_shard,
        variant="adaptive", params=asdict(p), sr=sr, channels=ch,
        total=total, out_path=out_path, wall_seconds=wall,
        realtime_factor=(total / sr) / wall if wall > 0 else 0.0)
