#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tomatis_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N] [--minutes M]

Phases, each fatal on failure (exit code != 0, no result line):
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the main path from csrc/ (sm_90a)
    and prints each kernel's registers and spills (-Xptxas -v);
 3. kernels vs plain: each entry point of csrc/ola.cu against its plain
    PyTorch version on the card: the standalone overlap-add at five
    shapes, the fused chunk tail bit for bit in every output at the main
    path's shapes and its edge cases; CUDA-event times of each kernel,
    its plain version and the library call beside the byte bound, and
    of the unfused chunk tail the fused kernel replaced;
 4. main path: process_array (default StandardParams, 48 kHz stereo,
    n_fft 4096, hop 2048, 1024 frames per chunk, pcm24, ramp on) over a
    synthetic programme of M minutes from the seed, twice (cold, then
    warm), launch counts read around each call (one fused chunk-tail
    launch per chunk, no standalone overlap-add), output cross-checked
    against the port's own CPU run of the first 60 s (and against a card
    run of those 60 s, profiled: device time by kernel, the device's
    busy share, and the chunk tail's device time per chunk beside the
    unfused composition's on the same chunk shapes);
 5. file path: process() on a 60 s WAV, output and state CSV checked;
 6. crossfade path: the same programme through xfade.process_array
    (gate_ui 60 on the linear map = -40 dBFS, xfade_ms 200 = 5 frames,
    pcm24): one fused chunk-tail launch per chunk and no standalone
    overlap-add, both gate states, 60 s against the port's CPU run within
    1e-5 with equal C1/C2 counts, and xfade.process() on the 60 s WAV
    whose state CSV must show some frame with 0 < alpha < 1;
 7. FLAC path: the 60 s programme written as in.flac (PCM_24) by the
    port, standard.process(in.flac -> out.flac) on the card; the output
    decodes to phase 5's samples bit for bit; the native codec (built in
    phase 2 from csrc/flac.cpp) must have been the reader and the writer;
 8. resume path: the same FLAC run with a checkpoint (256 frames per
    chunk, a snapshot every 2 chunks), stopped by an exception from the
    audio sink on its second flush, then rerun: the checkpoint is gone
    and out.flac and the state CSV equal an uninterrupted run's bytes;
 9. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}. Each path (standard, xfade, flac,
    resume) is driven with the launch counts set to 0 just before it and
    read just after: `launches_by_path` holds those readings, `launches`
    their sum.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
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


def time_samples(torch, fn, n: int = 20,
                 flush_bytes: int = 256 << 20) -> list:
    """n CUDA-event timed calls (ms), each after the L2 (50 MB) was
    flushed by writing a larger buffer (the main path meets its inputs
    cold or nearly so). A spin kernel of about 1 ms ahead of the flush
    keeps the device busy while the host enqueues the flush and the call,
    so the events time the device's work and not the wrapper's Python."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del flush
    return times


def time_ms(torch, fn, n: int = 20) -> float:
    return statistics.median(time_samples(torch, fn, n))


def copy_ms(torch, nbytes: int) -> float:
    """A device-to-device copy that reads and writes nbytes in all: what
    the card's memory delivers for that many bytes in one launch."""
    src = torch.zeros(nbytes // 8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(torch, lambda: dst.copy_(src))


def time_turns(torch, fns: list, n: int = 10) -> list:
    """Medians (ms) of each fn, timed in turns a, b, ..., ..., b, a with n
    calls per turn, so drift on the card touches every fn alike."""
    samples = [[] for _ in fns]
    for j in list(range(len(fns))) + list(reversed(range(len(fns)))):
        samples[j] += time_samples(torch, fns[j], n)
    return [statistics.median(t) for t in samples]


def ptxas_lines(text: str) -> list:
    """One line per compiled kernel from nvcc -Xptxas -v: registers,
    shared memory, stack and spills."""
    lines, name, frame = [], "?", ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"chunk_tail_kernelILi(\d)ELi(\d)ELi(\d)E", name)
            if t:
                mode = ("overlap_add", "f32", "pcm24")[int(t.group(1))]
                norm = ("eps", "floor8")[int(t.group(2))]
                c = {"0": "any C, scalar loop"}.get(t.group(3),
                                                    f"C={t.group(3)}")
                name = f"chunk_tail_kernel<{mode}, {norm}, {c}>"
        elif "spill" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
    return lines


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
        f" bound {bound_ms:.4f} ms at 3.35 TB/s (H100 SXM HBM3, data sheet);"
        f" a copy moving as many bytes {copy_ms(torch, read_b + write_b):.4f}"
        f" ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms)


def unfused_tail(cuda_ola, **kw):
    """chunk_tail_plain with the standalone overlap-add kernel for its two
    overlap-adds: the composition the fused kernel replaced on the main
    path."""
    plain = cuda_ola.overlap_add_plain
    cuda_ola.overlap_add_plain = cuda_ola.overlap_add_cuda
    try:
        return cuda_ola.chunk_tail_plain(**kw)
    finally:
        cuda_ola.overlap_add_plain = plain


def tail_inputs(torch, gen, F, C, n_fft, hop):
    """Chunk-tail inputs on the card: irFFT-like frames, the processors'
    symmetric Hann window, carried tails, an output gain of -1 dB."""
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).cuda()
    tail = n_fft - hop
    return dict(
        z=0.05 * torch.randn((F, C, n_fft), generator=gen, device="cuda"),
        win=win, win2=win * win,
        out_tail=0.05 * torch.randn((tail, C), generator=gen, device="cuda"),
        w_tail=torch.rand((tail,), generator=gen, device="cuda"),
        gain_lin=torch.tensor(10 ** (-1 / 20), dtype=torch.float32,
                              device="cuda"))


def tail_bytes(F, C, n_fft, hop, transport) -> int:
    """Bytes the chunk tail must move: each input read once (z, win, win2,
    the tails, the gain), each output written once (out, the carries and,
    for pcm24, the peaks and the PCM_24 bytes)."""
    k, tail = n_fft // hop, n_fft - hop
    L, W = (F + k - 1) * hop, F + k - 1
    b = 4 * (F * C * n_fft + 2 * n_fft + tail * C + tail)
    b += 4 * (L * C + tail * C + tail)
    if transport == "pcm24":
        b += 4 + 4 * W + 3 * L * C
    return b


def check_chunk_tail(torch, cuda_ola):
    """Fused kernel vs chunk_tail_plain, bit for bit in every output;
    times at the production shape and the ramp's chunk sizes."""
    cases = [  # F, C, n_fft, hop, n_valid, norm
        (1024, 2, 4096, 2048, 1024, "eps"),   # production
        (512, 2, 4096, 2048, 512, "eps"),     # ramp
        (256, 2, 4096, 2048, 256, "eps"),     # ramp
        (1024, 2, 4096, 2048, 700, "eps"),    # partial chunk
        (1024, 2, 4096, 2048, 0, "eps"),      # empty chunk
        (29, 2, 3072, 1024, 29, "eps"),       # K=3
        (29, 2, 4096, 1024, 20, "eps"),       # K=4, partial
        (1024, 1, 4096, 2048, 1024, "eps"),   # C=1
        (1024, 2, 4096, 2048, 1024, "floor8"),
        (37, 2, 300, 150, 30, "floor8"),      # hop % 4 != 0: scalar loop
        (16, 3, 512, 256, 16, "eps"),         # C=3: scalar loop
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for F, C, n_fft, hop, n_valid, norm in cases:
        a = tail_inputs(torch, gen, F, C, n_fft, hop)
        for transport in ("f32", "pcm24"):
            got = cuda_ola.chunk_tail_cuda(n_valid=n_valid, norm=norm,
                                           transport=transport, **a)
            ref = cuda_ola.chunk_tail_plain(n_valid=n_valid, norm=norm,
                                            transport=transport, **a)
            torch.cuda.synchronize()
            names = ("out", "peaks", "pcm", "ola_carry", "w_carry")
            for name, g, r in zip(names, got, ref):
                if (g is None) != (r is None):
                    fail(f"chunk tail {name} presence differs")
                if r is None:
                    continue
                if g.shape != r.shape or g.dtype != r.dtype \
                        or not torch.equal(g, r):
                    d = float((g.double() - r.double()).abs().max()) \
                        if g.shape == r.shape else float("nan")
                    fail(f"chunk tail {name} differs at "
                         f"{(F, C, n_fft, hop, n_valid, norm, transport)}: "
                         f"max|d| {d}")
                if r.dtype == torch.float32:
                    worst = max(worst, float((g - r).abs().max()))
        log(f"chunk tail {(F, C, n_fft, hop)} n_valid {n_valid} {norm}: "
            f"f32 and pcm24 bit-exact in every output")

    # the fixed cost under this timing: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    log(f"timing floor (one launch of a 1-element kernel): "
        f"{time_ms(torch, lambda: one.add_(1.0)):.4f} ms")
    timed = {}
    for F in (1024, 512, 256):
        C, n_fft, hop = 2, 4096, 2048
        a = tail_inputs(torch, gen, F, C, n_fft, hop)
        for transport in ("f32", "pcm24"):
            fns = [lambda: cuda_ola.chunk_tail_plain(n_valid=F,
                                                     transport=transport, **a),
                   lambda: unfused_tail(cuda_ola, n_valid=F,
                                        transport=transport, **a),
                   lambda: cuda_ola.chunk_tail_cuda(n_valid=F,
                                                    transport=transport, **a)]
            plain_ms, unfused_ms, ms = time_turns(torch, fns)
            nbytes = tail_bytes(F, C, n_fft, hop, transport)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            timed[(F, transport)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms)
            log(f"chunk tail {(F, C, n_fft, hop)} {transport}: kernel "
                f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB"
                f" at 3.35 TB/s, {100 * bound_ms / ms:.0f}% of it; a copy "
                f"moving as many bytes {copy_ms(torch, nbytes):.4f} ms); "
                f"chunk_tail_plain, PR 1's composed chunk tail (the main "
                f"path's before-figure) {plain_ms:.4f} ms; the same "
                f"composition with the standalone OLA kernel {unfused_ms:.4f}"
                f" ms")
    return dict(max_abs_err=worst, library_ms=None,
                **timed[(1024, "pcm24")])


def chunk_schedule(standard, p, n: int) -> list:
    """(frames per chunk, valid frames) of each chunk of an n-sample
    process_array call, as its StreamRunner cuts the stream."""
    runner = standard.make_runner(p, SR, 2, n, 1024, transport="pcm24",
                                  device="cuda")
    out, frame0, n_frames = [], 0, runner.plan.n_frames
    while frame0 < n_frames:
        f = runner._chunk_F(frame0)
        out.append((f, min(f, n_frames - frame0)))
        frame0 += out[-1][1]
    return out


def device_ms(prof, match: str = "") -> tuple:
    """(device ms, launches) of the profiled device events whose name
    holds `match` (all of them for "")."""
    from torch.autograd import DeviceType
    ms, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and match in evt.key:
            ms += getattr(evt, "self_device_time_total",
                          getattr(evt, "self_cuda_time_total", 0)) / 1e3
            count += evt.count
    return ms, count


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


def reset_counts(cuda_ola):
    """Set both launch counts to 0, just before a path is driven."""
    cuda_ola.overlap_add_cuda.launches = 0
    cuda_ola.chunk_tail_cuda.launches = 0


def read_counts(cuda_ola, chunks: int, what: str) -> dict:
    """The launch counts just after a path was driven; fails unless it
    made one fused chunk-tail launch per chunk and no standalone
    overlap-add launch."""
    n_tail = cuda_ola.chunk_tail_cuda.launches
    n_ola = cuda_ola.overlap_add_cuda.launches
    if n_tail == 0 or n_tail != chunks or n_ola != 0:
        fail(f"{what}: {n_tail} chunk-tail and {n_ola} overlap-add "
             f"launches over {chunks} chunks (expected one chunk-tail "
             f"launch per chunk and no overlap-add)")
    return {"chunk_tail": n_tail, "overlap_add": n_ola}


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
    from tomatis_tpu_torch.models import standard, xfade
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.native.build import BUILD_LOG, load_library
    from tomatis_tpu_torch.ops import cuda_ola
    from tomatis_tpu_torch.utils.stateio import read_state_csv

    # -- 2. build ------------------------------------------------------------
    # one compiler per source, started together: nvcc for the kernels,
    # the host C++ compiler for the FLAC codec
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {"csrc/ola.cu": pool.submit(cuda_ola.build),
                "csrc/flac.cpp": pool.submit(load_library, "flac")}
        for src, job in jobs.items():
            try:
                job.result()
            except Exception as e:   # reported, then the run fails
                fail(f"{src} did not build: {e}")
    log(f"build: {time.perf_counter() - t0:.1f} s (csrc/ola.cu with nvcc and "
        f"csrc/flac.cpp with the host C++ compiler, in parallel; compiled in "
        f"this run: {sorted(BUILD_LOG)}, a library newer than its source is "
        f"kept)")
    for src, text in BUILD_LOG.items():
        for ln in ptxas_lines(text):
            log(f"ptxas {src}: {ln}")

    # -- 3. kernels vs plain -------------------------------------------------
    ola = check_ola(torch, cuda_ola)
    tail = check_chunk_tail(torch, cuda_ola)

    # -- 4. main path --------------------------------------------------------
    x = programme(args.minutes * 60.0, args.seed)
    p = standard.StandardParams()
    log(f"main path: {len(x)} sample frames ({len(x) / SR:.0f} s) stereo")
    launches = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(cuda_ola)
        t0 = time.perf_counter()
        y, stats = standard.process_array(x, SR, p, frames_per_chunk=1024,
                                          device="cuda", transport="pcm24")
        wall = time.perf_counter() - t0
        counts = read_counts(cuda_ola, stats["chunks"], f"{run} run")
        n_tail, n_ola = counts["chunk_tail"], counts["overlap_add"]
        launches.setdefault("standard", counts)
        if y.shape != x.shape or not np.all(np.isfinite(y)):
            fail(f"main path output shape {y.shape} or non-finite values")
        if not (stats["c1_frames"] > 0 and stats["c2_frames"] > 0):
            fail(f"the gate never switched: {stats}")
        if np.max(np.abs(y)) > 0.999 + 1e-6:
            fail("output exceeds the 0.999 peak limit")
        log(f"main path ({run}): {stats['chunks']} chunks, {n_tail} "
            f"chunk-tail launches, {n_ola} overlap-add launches, C1 "
            f"{stats['c1_frames']} / C2 {stats['c2_frames']} frames, wall "
            f"{wall:.3f} s, realtime factor {len(x) / SR / wall:.2f}x, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB, stages {stats['timings']}")

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
    # the chunk tail's device time per chunk: the fused kernel in the
    # profiled call, and both forms replayed on that call's chunk shapes
    fused_ms, fused_n = device_ms(prof, "chunk_tail_kernel")
    sched = chunk_schedule(standard, p, len(x60))
    gen = torch.Generator(device="cuda").manual_seed(2)
    ins = [(tail_inputs(torch, gen, f, 2, p.n_fft, p.hop), nv)
           for f, nv in sched]
    replay = {}
    for name, fn in (("unfused", lambda a, nv: unfused_tail(
                          cuda_ola, n_valid=nv, transport="pcm24",
                          **a)),
                     ("fused", lambda a, nv: cuda_ola.chunk_tail_cuda(
                          n_valid=nv, transport="pcm24", **a))):
        for a, nv in ins:       # warm: allocator and first-launch set-up
            fn(a, nv)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as rprof:
            for a, nv in ins:
                fn(a, nv)
            torch.cuda.synchronize()
        replay[name] = device_ms(rprof)
    log(f"chunk tail device time per chunk ({len(sched)} chunks "
        f"{sched}): main path (fused kernel, {fused_n} launches) "
        f"{fused_ms / max(fused_n, 1):.4f} ms; replay on the same chunk "
        f"shapes: unfused composition {replay['unfused'][0] / len(sched):.4f}"
        f" ms ({replay['unfused'][1] / len(sched):.1f} device launches per "
        f"chunk), fused {replay['fused'][0] / len(sched):.4f} ms "
        f"({replay['fused'][1] / len(sched):.1f} per chunk)")
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
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
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
    y_wav, _ = audio.read(op)

    # -- 6. crossfade path ---------------------------------------------------
    # gate_ui 60 on the linear map is -40 dBFS, the standard path's
    # threshold; 200 ms is 5 frames of 2048 samples at 48 kHz
    px = xfade.XfadeParams(gate_ui=60.0, xfade_ms=200.0)
    if px.threshold_dbfs() != p.threshold_dbfs() or px.xfade_frames(SR) != 5:
        fail(f"crossfade parameters: threshold {px.threshold_dbfs()}, "
             f"{px.xfade_frames(SR)} frames")
    for run in ("cold", "warm"):
        reset_counts(cuda_ola)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yx, stx = xfade.process_array(x, SR, px, frames_per_chunk=1024,
                                      device="cuda", transport="pcm24")
        wall = time.perf_counter() - t0
        counts = read_counts(cuda_ola, stx["chunks"], f"crossfade {run} run")
        launches.setdefault("xfade", counts)
        if yx.shape != x.shape or not np.all(np.isfinite(yx)):
            fail(f"crossfade output shape {yx.shape} or non-finite values")
        if not (stx["c1_frames"] > 0 and stx["c2_frames"] > 0):
            fail(f"crossfade path: the gate never switched: {stx}")
        if np.max(np.abs(yx)) > 0.999 + 1e-6:
            fail("crossfade output exceeds the 0.999 peak limit")
        log(f"crossfade path ({run}): {stx['chunks']} chunks, "
            f"{counts['chunk_tail']} chunk-tail launches, "
            f"{counts['overlap_add']} overlap-add launches, C1 "
            f"{stx['c1_frames']} / C2 {stx['c2_frames']} frames, wall "
            f"{wall:.3f} s, realtime factor {len(x) / SR / wall:.2f}x, "
            f"stages {stx['timings']}")
    yx_cpu, stx_cpu = xfade.process_array(x60, SR, px, device="cpu",
                                          transport="pcm24")
    yx_gpu, stx_gpu = xfade.process_array(x60, SR, px, device="cuda",
                                          transport="pcm24")
    dx_main = float(np.max(np.abs(yx[:upto] - yx_cpu[:upto])))
    dx_60 = float(np.max(np.abs(yx_gpu - yx_cpu)))
    if dx_main > 1e-5 or dx_60 > 1e-5:
        fail(f"crossfade card vs CPU output: main {dx_main}, 60 s {dx_60} "
             f"> 1e-5")
    for k in ("n_frames", "c1_frames", "c2_frames"):
        if stx_gpu[k] != stx_cpu[k]:
            fail(f"crossfade card vs CPU {k}: {stx_gpu[k]} != {stx_cpu[k]}")
    xop, xcp = os.path.join(tmp, "xf.wav"), os.path.join(tmp, "xf.csv")
    xst = xfade.process(ip, xop, px, state_csv_path=xcp, device="cuda")
    alpha = read_state_csv(xcp)["alpha"]
    n_mid = int(np.sum((alpha > 0) & (alpha < 1)))
    if n_mid == 0 or not (np.any(alpha == 0) and np.any(alpha == 1)):
        fail(f"crossfade state CSV: {n_mid} frames with 0 < alpha < 1, "
             f"range {alpha.min()}..{alpha.max()}")
    xmeta = audio.info(xop)
    if xmeta.frames != len(x60) or xmeta.subtype != "PCM_24":
        fail(f"crossfade file path wrote {xmeta}")
    log(f"crossfade cross-check vs CPU: max|d| main path {dx_main:.3e} "
        f"(first {upto} samples), 60 s run {dx_60:.3e}; C1/C2 "
        f"{stx_gpu['c1_frames']}/{stx_gpu['c2_frames']} equal; state CSV "
        f"{len(alpha)} rows, {n_mid} with 0 < alpha < 1; file path wall "
        f"{xst['wall_seconds']:.3f} s, realtime factor "
        f"{xst['realtime_factor']:.2f}x")

    # -- 7. FLAC path --------------------------------------------------------
    fip, fop = os.path.join(tmp, "in.flac"), os.path.join(tmp, "out.flac")
    fcp = os.path.join(tmp, "flac.csv")
    t0 = time.perf_counter()
    audio.write(fip, x60, SR, subtype="PCM_24")
    enc_s = time.perf_counter() - t0
    with audio.AudioFile(fip) as f:
        reader = type(f._h).__name__
    with audio.AudioFile(os.path.join(tmp, "probe.flac"), "w",
                         samplerate=SR, channels=2) as f:
        writer = type(f._h).__name__
    if reader != "_NativeFlacReader" or writer != "FlacWriter":
        fail(f"the native FLAC codec did not run: reader {reader}, writer "
             f"{writer}")
    reset_counts(cuda_ola)
    flst = standard.process(fip, fop, p, state_csv_path=fcp, device="cuda")
    launches["flac"] = read_counts(cuda_ola, flst["chunks"], "FLAC path")
    if flst["out_path"] != fop or audio.info(fop).format != "FLAC":
        fail(f"FLAC path wrote {flst['out_path']}")
    y_flac, _ = audio.read(fop)
    if y_flac.shape != y_wav.shape or not np.array_equal(y_flac, y_wav):
        fail("FLAC path: out.flac does not decode to the WAV run's samples")
    if open(fcp).read() != open(cp).read():
        fail("FLAC path: state CSV differs from the WAV run's")
    log(f"FLAC path: reader {reader}, writer {writer} (native, "
        f"csrc/flac.cpp); in.flac {os.path.getsize(fip)} bytes encoded in "
        f"{enc_s:.3f} s; out.flac {os.path.getsize(fop)} bytes decodes to "
        f"the WAV run's {y_flac.shape[0]} frames bit for bit; state CSV "
        f"equal; wall {flst['wall_seconds']:.3f} s, realtime factor "
        f"{flst['realtime_factor']:.2f}x, stages {flst['timings']}")

    # -- 8. resume path ------------------------------------------------------
    ck = os.path.join(tmp, "ck.npz")
    rop, rcp = os.path.join(tmp, "res.flac"), os.path.join(tmp, "res.csv")
    uop, ucp = os.path.join(tmp, "unint.flac"), os.path.join(tmp, "unint.csv")
    kw = dict(frames_per_chunk=256, device="cuda")
    ust = standard.process(fip, uop, p, state_csv_path=ucp, **kw)

    class SinkStopped(Exception):
        pass

    flushes = [0]
    write_raw = standard._RawWav.write_raw

    def stop_on_second(self, raw):
        flushes[0] += 1
        if flushes[0] > 1:
            raise SinkStopped()
        return write_raw(self, raw)

    standard._RawWav.write_raw = stop_on_second
    try:
        standard.process(fip, rop, p, state_csv_path=rcp, checkpoint_path=ck,
                         checkpoint_every=2, **kw)
    except SinkStopped:
        pass
    else:
        fail("resume path: the sink's exception did not stop the run")
    finally:
        standard._RawWav.write_raw = write_raw
    if not os.path.exists(ck) or not os.path.exists(rop + ".part.wav"):
        fail("resume path: no checkpoint or no staged WAV after the stop")
    reset_counts(cuda_ola)
    rst = standard.process(fip, rop, p, state_csv_path=rcp,
                           checkpoint_path=ck, checkpoint_every=2, **kw)
    launches["resume"] = read_counts(cuda_ola, rst["chunks"], "resume path")
    if os.path.exists(ck) or os.path.exists(rop + ".part.wav"):
        fail("resume path: the checkpoint or the staged WAV was left behind")
    if not 0 < rst["chunks"] < ust["chunks"]:
        fail(f"resume path: the rerun took {rst['chunks']} chunks of "
             f"{ust['chunks']}: it did not resume mid-stream")
    if open(rop, "rb").read() != open(uop, "rb").read() \
            or open(rcp).read() != open(ucp).read():
        fail("resume path: out.flac or the state CSV differs from the "
             "uninterrupted run's")
    same = np.array_equal(audio.read(uop)[0], y_flac)
    log(f"resume path: stopped on flush 2, resumed with {rst['chunks']} of "
        f"{ust['chunks']} chunks left; out.flac ({os.path.getsize(rop)} "
        f"bytes) and the state CSV equal the uninterrupted run's byte for "
        f"byte; checkpoint removed; the 256-frame run's samples "
        f"{'equal' if same else 'differ from'} the 1024-frame run's")
    tmp_dir.cleanup()

    # -- 9. result -----------------------------------------------------------
    kernels = [dict(name=name, route="cuda",
                    source="tomatis_tpu_torch/csrc/ola.cu",
                    replaces="tomatis_tpu/ops/pallas_ola.py:75",
                    launches=sum(c[name] for c in launches.values()),
                    launches_by_path={k: c[name]
                                      for k, c in launches.items()},
                    bound_by="bytes", **res)
               for name, res in (("overlap_add", ola), ("chunk_tail", tail))]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
