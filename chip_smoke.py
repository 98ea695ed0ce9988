#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tomatis_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N] [--minutes M]

Phases, each fatal on failure (exit code != 0, no result line):
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the main path from csrc/ (sm_90a);
 3. kernels vs plain: each kernel's wrapper against its plain PyTorch
    version on the card at the main path's shapes, with CUDA-event times
    of the kernel, the plain version and the library call beside the
    byte bound;
 4. main path: process_array (default StandardParams, 48 kHz stereo,
    n_fft 4096, hop 2048, 1024 frames per chunk, pcm24, ramp on) over a
    synthetic programme of M minutes from the seed, launch counts read
    around that one call, output cross-checked against the port's own
    CPU run of the first 60 s (and against a card run of those 60 s,
    profiled: device time by kernel and the device's busy share);
 5. file path: process() on a 60 s WAV, output and state CSV checked;
 6. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 48000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s


def fail(msg: str):
    print(f"[FAIL] {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int = 20, flush_bytes: int = 256 << 20) -> float:
    """Median of n CUDA-event timed calls, each after the L2 (50 MB) was
    flushed by writing a larger buffer (the main path meets its inputs
    cold or nearly so)."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del flush
    return statistics.median(times)


def programme(seconds: float, seed: int) -> np.ndarray:
    """Synthetic stereo programme: passages of 2-8 s alternating between
    quiet (~-52 dBFS) and loud (~-28 dBFS) around the default -40 dBFS
    gate, tones plus noise, peaks well below the 0.999 clamp."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = np.empty(n, np.float32)
    pos, loud = 0, False
    while pos < n:
        m = int(rng.uniform(2.0, 8.0) * SR)
        env[pos:pos + m] = 0.05 if loud else 0.003
        pos += m
        loud = not loud
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    tone = (np.sin(2 * np.pi * 440.0 * t)
            + 0.5 * np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)
    del t
    x = np.empty((n, 2), np.float32)
    for c in range(2):
        noise = rng.standard_normal(n, dtype=np.float32) * np.float32(0.3)
        x[:, c] = env * (tone * np.float32(1.0 - 0.2 * c) + noise)
    return x


def check_ola(torch, cuda_ola):
    """Kernel vs plain at the main path's shapes; times at production."""
    shapes = [(1024, 2, 4096, 2048),   # production frames, K=2
              (1024, 1, 4096, 2048),   # the normaliser
              (29, 2, 4096, 1024),     # K=4
              (12, 2, 384, 128),       # K=3, odd F
              (1, 2, 256, 128)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for F, C, n_fft, hop in shapes:
        y = torch.randn((F, C, n_fft), generator=gen, device="cuda")
        got = cuda_ola.overlap_add_cuda(y, hop)
        ref = cuda_ola.overlap_add_plain(y, hop)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"OLA shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        tol = 1e-6 * float(ref.abs().max())
        if not err <= tol or (n_fft // hop == 2 and err != 0.0):
            fail(f"OLA kernel disagrees at {(F, C, n_fft, hop)}: "
                 f"max|d| {err} > {tol}")
        worst = max(worst, err)
        log(f"ola {(F, C, n_fft, hop)}: max|d| {err:.3e} (tol {tol:.3e})")

    F, C, n_fft, hop = shapes[0]
    L = (F - 1) * hop + n_fft
    y = torch.randn((F, C, n_fft), generator=gen, device="cuda")
    ms = time_ms(torch, lambda: cuda_ola.overlap_add_cuda(y, hop))
    plain_ms = time_ms(torch, lambda: cuda_ola.overlap_add_plain(y, hop))
    # library yardstick: col2im with kernel (1, n_fft), stride (1, hop) is
    # the same overlap-add, on fold's own channel-major layout
    yf = y.permute(1, 2, 0).reshape(1, C * n_fft, F).contiguous()

    def fold():
        return torch.nn.functional.fold(yf, output_size=(1, L),
                                        kernel_size=(1, n_fft),
                                        stride=(1, hop))
    ref = cuda_ola.overlap_add_plain(y, hop)
    f_err = float((fold()[0, :, 0, :].T - ref).abs().max())
    if f_err > 1e-5:
        fail(f"fold yardstick disagrees with the plain OLA: {f_err}")
    library_ms = time_ms(torch, fold)
    w = torch.rand((F, 1, n_fft), generator=gen, device="cuda")
    norm_ms = time_ms(torch, lambda: cuda_ola.overlap_add_cuda(w, hop))
    read_b, write_b = F * C * n_fft * 4, L * C * 4
    bound_ms = (read_b + write_b) / HBM_BYTES_PER_S * 1e3
    log(f"ola production {(F, C, n_fft, hop)}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.fold {library_ms:.4f} ms; normaliser "
        f"{(F, 1, n_fft, hop)} kernel {norm_ms:.4f} ms")
    log(f"ola bytes per production launch: {read_b / 1e6:.1f} MB read + "
        f"{write_b / 1e6:.1f} MB written = {(read_b + write_b) / 1e6:.1f} MB;"
        f" bound {bound_ms:.4f} ms at 3.35 TB/s (H100 SXM HBM3, data sheet)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms)


def report_profile(prof, wall_s: float, top: int = 8):
    """Device time by kernel (and copy), the device's busy share of the
    wall time of one profiled call (one stream, so device events do not
    overlap), and the host operators with the most self CPU time."""
    from torch.autograd import DeviceType
    dev_rows, host_rows = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            dev_rows.append((dev_us, evt.count, evt.key))
        else:
            host_rows.append((evt.self_cpu_time_total, evt.count, evt.key))
    if not dev_rows:
        log("profile: no device events in the trace (not measured)")
        return
    busy_ms = sum(r[0] for r in dev_rows) / 1e3
    log(f"profile: device busy {busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms "
        f"wall ({100 * busy_ms / (wall_s * 1e3):.1f}% busy)")
    for us, count, key in sorted(dev_rows, reverse=True)[:top]:
        log(f"profile:   device {us / 1e3:9.3f} ms  x{count:<5d} {key[:80]}")
    for us, count, key in sorted(host_rows, reverse=True)[:top]:
        log(f"profile:   host   {us / 1e3:9.3f} ms  x{count:<5d} {key[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--minutes", type=float, default=10.0)
    args = ap.parse_args()

    # -- 1. card -------------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sys.path.insert(0, HERE)
    from tomatis_tpu_torch.models import standard
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.native.build import BUILD_LOG
    from tomatis_tpu_torch.ops import cuda_ola
    from tomatis_tpu_torch.utils.stateio import read_state_csv

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_ola.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, text in BUILD_LOG.items():
        log(f"nvcc {src}: {' | '.join(text.split(chr(10))[-4:]).strip()}")

    # -- 3. kernels vs plain -------------------------------------------------
    ola = check_ola(torch, cuda_ola)

    # -- 4. main path --------------------------------------------------------
    x = programme(args.minutes * 60.0, args.seed)
    p = standard.StandardParams()
    log(f"main path: {len(x)} sample frames ({len(x) / SR:.0f} s) stereo")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ola.overlap_add_cuda.launches = 0
    t0 = time.perf_counter()
    y, stats = standard.process_array(x, SR, p, frames_per_chunk=1024,
                                      device="cuda", transport="pcm24")
    wall = time.perf_counter() - t0
    launches = cuda_ola.overlap_add_cuda.launches
    if launches == 0 or launches != 2 * stats["chunks"]:
        fail(f"OLA kernel launched {launches} times over "
             f"{stats['chunks']} chunks (expected 2 per chunk)")
    if y.shape != x.shape or not np.all(np.isfinite(y)):
        fail(f"main path output shape {y.shape} or non-finite values")
    if not (stats["c1_frames"] > 0 and stats["c2_frames"] > 0):
        fail(f"the gate never switched: {stats}")
    if np.max(np.abs(y)) > 0.999 + 1e-6:
        fail("output exceeds the 0.999 peak limit")
    log(f"main path: {stats['chunks']} chunks, {launches} OLA launches, "
        f"C1 {stats['c1_frames']} / C2 {stats['c2_frames']} frames, wall "
        f"{wall:.3f} s, realtime factor {len(x) / SR / wall:.2f}x, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"stages {stats['timings']}")

    # cross-check the first 60 s against the port's own CPU run
    x60 = np.ascontiguousarray(x[:60 * SR])
    y_cpu, st_cpu = standard.process_array(x60, SR, p, device="cpu",
                                           transport="pcm24")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        y_gpu, st_gpu = standard.process_array(x60, SR, p, device="cuda",
                                               transport="pcm24")
        wall60 = time.perf_counter() - t0
    report_profile(prof, wall60)
    from tomatis_tpu_torch.engine.streaming import flush_plan
    # the 60 s run's last flush cut may clamp differently from the long run
    upto = flush_plan(len(x60), p.n_fft, p.hop).cuts[-1][0]
    d_main = float(np.max(np.abs(y[:upto] - y_cpu[:upto])))
    d_60 = float(np.max(np.abs(y_gpu - y_cpu)))
    if d_main > 1e-5 or d_60 > 1e-5:
        fail(f"card vs CPU output: main {d_main}, 60 s {d_60} > 1e-5")
    for k in ("n_frames", "c1_frames", "c2_frames"):
        if st_gpu[k] != st_cpu[k]:
            fail(f"card vs CPU {k}: {st_gpu[k]} != {st_cpu[k]}")
    log(f"cross-check vs CPU: max|d| main path {d_main:.3e} (first {upto} "
        f"samples), 60 s run {d_60:.3e}; C1/C2 {st_gpu['c1_frames']}/"
        f"{st_gpu['c2_frames']} equal")

    # -- 5. file path --------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ip, op = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        cp = os.path.join(tmp, "state.csv")
        audio.write(ip, x60, SR, subtype="PCM_24")
        fst = standard.process(ip, op, p, state_csv_path=cp, device="cuda")
        meta = audio.info(op)
        if meta.frames != len(x60) or meta.subtype != "PCM_24":
            fail(f"file path wrote {meta}")
        csvd = read_state_csv(cp)
        n_rows = sum(1 for j in range(fst["n_frames"])
                     if 0 <= -p.n_fft // 2 + j * p.hop < len(x60))
        if (len(csvd["frame_idx"]) != n_rows
                or not set(csvd["state"]) == {"C1", "C2"}):
            fail(f"state CSV: {len(csvd['frame_idx'])} rows (expected "
                 f"{n_rows}), states {set(csvd['state'])}")
        log(f"file path: {meta.frames} frames PCM_24, {n_rows} CSV rows, "
            f"wall {fst['wall_seconds']:.3f} s, realtime factor "
            f"{fst['realtime_factor']:.2f}x")

    # -- 6. result -----------------------------------------------------------
    kernels = [dict(name="overlap_add", route="cuda",
                    source="tomatis_tpu_torch/csrc/ola.cu",
                    replaces="tomatis_tpu/ops/pallas_ola.py:75",
                    launches=launches, bound_by="bytes", **ola)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
