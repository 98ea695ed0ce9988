#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tomatis_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N] [--minutes M]

Phases, each fatal on failure (exit code != 0, no result line):
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the main path from csrc/ (sm_90a)
    and prints each kernel's registers and spills (-Xptxas -v); the host
    C++ compiler builds csrc/flac.cpp and csrc/wire.cpp beside it;
 3. kernels vs plain: each entry point of csrc/ola.cu against its plain
    PyTorch version on the card: the standalone overlap-add at nine
    shapes (the sharded path's [256, 2, 4096] and [256, 1, 4096] and the
    CPU tests' [23, C, 1024] among them), the fused chunk tail bit for
    bit in every output at the main path's shapes and its edge cases;
    CUDA-event times of each kernel, its plain version and the library
    call beside the byte bound and a copy of the same bytes (the
    overlap-add at the shard shapes and at production), and of the
    unfused chunk tail the fused kernel replaced;
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
 9. adaptive path: adaptive.process_array over the M-minute programme,
    cold then warm: one fused chunk-tail launch per chunk, every one the
    ("floor8", "f32", C=2) variant, no standalone overlap-add; both gate
    states and some 0 < alpha < 1; the stage times printed. Then
    adaptive.process() file to file on the 60 s WAV and on a 60 s MONO
    44.1 kHz WAV (the C=1 variant) against the port's CPU run: max|d| <=
    1e-5 (plus 2e-7/win[k] on the stream's edge hops, where the output is
    z/win[k]), thresholds equal to 1e-3 dB, C1/C2 counts and the state
    column equal;
10. EQ appliers: apply_eq on a 60 s FLAC (a frame of silence at both
    ends, +20 dB input gain so the gain-protect copy runs) with a
    synthetic curve CSV, pad on, pcm24, and apply_residual_eq --safe WAV
    to WAV on the raw programme (no pad: the normaliser meets w ~ 0 at
    both ends), each against the port's CPU run: launches per chunk,
    output length F*hop + n_fft - hop, interior within 4 LSB, peak_seen
    equal to 1e-5 relative (where the peak sits on an edge sample
    z*win[k]/(win[k]**2 + 1e-12), it is rebuilt in float64 and held to
    1e-7 of z scaled as that sample is);
11. EQ resume: apply_eq FLAC to FLAC with a checkpoint at 256 frames per
    chunk, stopped on the third chunk's write, rerun: bytes equal an
    uninterrupted run's, no checkpoint or staged WAV left;
12. match: a synthetic 60 s original and a "device" rendition made by
    the port's standard processor on the card (known threshold, gain and
    a spectral tilt), workflow.match_device on the card: every artifact
    written, T_raw within 2 dB of the truth, layer 2 tighter than layer 1,
    final music_err < 0.4 dB; each stage's wall printed, the grid gate's
    on its own line, and the grid gate alone at a 6-minute deployment's
    size (8437 frames, 37908 lanes);
13. declick: planted clicks are found and repaired, a clean file passes
    through;
14. wire codec on the card: for the production chunk shape
    ([2_099_200, 2] int32 quantised from the programme), a mono one, a
    16-bit-sourced one (wasted bits on the host encoder), full-scale
    noise (the raw escape) and digital silence, rice off and on:
    pack_device on the card equals the C++ encoder byte for byte (where
    that one strips no wasted bits) and, at a 50_000-sample cut, the
    numpy oracle encode_np(wasted=False); unpack_device on the card of
    the host-encoded stream equals the floats exactly; card pack -> C++
    decode_pcm24 equals the pcm24 bytes. CUDA-event ms of pack and
    unpack beside their byte bounds, the stream's bytes per sample, the
    C++ encode and decode ms per chunk;
15. the long file: the M-minute programme as a FLAC through process()
    to FLAC on pcm24 (the default): one chunk-tail launch per chunk, its
    stages, wall and peak device memory;
16. the threaded pipeline, measured: phase 15's stage timers and wall
    beside this script's own timing of decoding the whole input and of
    encoding the whole output alone and the array run's stream stages,
    and the encoder's microseconds per 4096-frame block on one thread
    (a child process whose affinity is one CPU: no helper threads);
    the same for apply_eq on that FLAC; peak device memory with three
    chunks in flight;
17. convert: FLAC -> WAV -> FLAC through the int24 copy keeps every
    sample;
18. process-batch: (a) the batched chunk tail (a lane axis, one launch
    for every lane) against chunk_tail_batched_plain bit for bit in every
    output at B = 1, 4, 8 on the production shape [B, 1024, 2, 4096] with
    mixed n_valid (full, partial, 0), at the C = 1 and scalar-loop shapes,
    and B = 1 against chunk_tail_cuda; CUDA-event times at B = 1, 4, 8
    beside the byte bound, a device copy of the same bytes and B
    single-file launches in a row. (b) eight FLAC lanes of 90-150 s cut
    from the programme through process_batch on the card, B = 8 and B = 4:
    each lane's file and state CSV equal to standard.process on that file
    with TOMATIS_NO_RAMP=1 byte for byte, one batched launch per batch
    chunk and no single-file one; a corrupt lane fails alone; walls,
    aggregate realtime factor, LAST_TIMINGS, peak device memory, the
    single-file walls' sum, and the lanes' codecs alone, a thread each
    side by side (the encoder's helpers besides);
19. doctor: `doctor` in this process on the card exits 0 (its kernel
    check holds one chunk_tail_cuda launch against chunk_tail_plain bit
    for bit; its engine run launches the chunk tail per chunk);
20. verifiers: the CLI `process` and `process-adaptive` on the 60 s WAV,
    then validate and verify-15db on the standard output and
    verify-15db-v2 on the adaptive one with no parameter flag (the
    params sidecar drives them), verify-tilt on the standard output: the
    CLI on the card, then the library call with the same arguments on
    the card and on the CPU, which must give the same verdicts, counts
    and flags, metrics within 1e-3 dB and spectrum CSVs within 1e-2 dB
    per bin. Then validate and verify-15db at full size, on the
    10-minute FLAC to FLAC pcm24 output of phase 15 with its state CSV
    and a sidecar: verdict, wall, its split (decode, gate recomputation,
    conditional spectrum, tilt index) and peak device memory;
21. case study: run_case_study (40 s) on the card within
    tests/test_case_study.py's tolerances, chunk-tail launches > 0;
22. analyzers: the ten analyzer commands on the 60 s files;
    analyze-stereo on the card and on the CPU writes the same CSV bytes,
    the host-only commands run twice and print and write the same;
23. process-sharded at full size: the M-minute programme as a 48 kHz
    stereo PCM_24 WAV through process_sharded (default StandardParams,
    frames_per_shard 256, a 4-shard mesh on the one card,
    devices=[cuda:0]*4): output WAV and state CSV equal to the
    single-device `process` run's bytes, mesh {"data": 1, "seq": 4}, two
    overlap_add_cuda launches per shard and super-chunk and no chunk-tail
    launch; wall, realtime factor and split (read, step, write) beside
    the single-device wall, peak device memory;
24. the sharded variants and the CLI on the 60 s WAV: xfade (gate_ui 60,
    xfade_ms 200) within 1 PCM_24 LSB of xfade.process on under 1% of
    samples with agreeing state CSV rows, adaptive within 1 LSB of
    adaptive.process with the same threshold, attenuation, switch count
    and state CSV, and `process-sharded` with no --devices (one shard per
    card) equal to `process`;
25. sharded resume: a checkpointed 4-shard run stopped by its sink after
    two snapshots, a rerun on 2 shards refused, the rerun on 4 equal to
    the uninterrupted bytes;
26. process-batch devices=[cuda:0]*2: three of phase 18's FLAC lanes in
    two lane blocks (padded to 4 lanes), one batched launch per block and
    chunk, every lane byte-equal to its devices=None run;
27. compare-baseline, compare-three, compare-diff-spectrum and plot-diff
    on the 60 s input and its `process` output, and reverse-engineer: the
    commands on the card, then the library calls on the card and on the
    CPU (reverse-engineer on tests/test_reverse.py's signal, 60 s, and
    its rendition on the card): equal delays, frame counts and counts,
    bands, music_err,
    noise_delta, CSV rows and the threshold estimate within 1e-3 dB; which
    PNGs were written (none where matplotlib does not import);
28. process-batch on wire, which process_batch picks on a link slower
    than WIRE_BATCH_LINK_MBPS: the rule must keep pcm24 on this card's
    link, and the wire runs raise the threshold past it. (a) phase 18's
    eight FLAC lanes at B = 8, in turns with pcm24 (pcm24, wire, wire,
    pcm24): every lane's FLAC and state CSV equal the pcm24 run's byte
    for byte, one batched launch per batch chunk and no single-file one;
    walls, aggregate realtime factor, LAST_TIMINGS, LAST_WIRE
    (shipped/used both ways), peak device memory, and the link rate below
    which wire's saved bytes pay for its extra wall. (b) the 10-minute
    FLAC of phase 15 beside the 60 s FLAC, in turns with pcm24 (wire,
    pcm24, pcm24, wire): bytes equal, walls. (c) a 20 s
    FLOAT WAV that is not PCM_24-exact beside the 60 s FLAC: its chunks
    ship raw floats, the later ones the codec, bytes equal to pcm24's. No
    call reaches the numpy wire codec in this process;
29. the package's public surface: the M-minute programme as a WAV
    through tomatis_tpu_torch.process (the top-level name) and through
    the function pyproject.toml installs as `tomatis-torch` running
    `process`, each byte-equal (WAV and state CSV) to
    models.standard.process on the same file in this call with one
    chunk-tail launch per chunk and no overlap-add; then `validate` on
    the 60 s output of phase 5 in child processes: TOMATIS_PLATFORM=cpu
    with no --device gives --device cpu's console text and CSV and leaves
    CUDA uninitialised, and --device cuda under the same variable
    initialises the card;
30. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}. Each path is driven with the
    launch counts set to 0 just before it and read just after:
    `launches_by_path` holds those readings, `launches` their sum;
    `launches_by_frames` the chunk tail's by chunk size (the ramp's 256
    and 512 frames, then 1024) on each single-file path.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
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
            t = re.search(r"chunk_tail_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)E",
                          name)
            if t:
                mode = ("overlap_add", "f32", "pcm24")[int(t.group(1))]
                norm = ("eps", "floor8")[int(t.group(2))]
                c = {"0": "any C, scalar loop"}.get(t.group(3),
                                                    f"C={t.group(3)}")
                lanes = ", lanes" if t.group(4) == "1" else ""
                name = f"chunk_tail_kernel<{mode}, {norm}, {c}{lanes}>"
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
    """Kernel vs plain at the main path's shapes; times at production and
    at the sharded path's shard shapes."""
    shapes = [(1024, 2, 4096, 2048),   # production frames, K=2
              (1024, 1, 4096, 2048),   # the normaliser
              (256, 2, 4096, 2048),    # a process-sharded shard's frames
              (256, 1, 4096, 2048),    # ... and its window weights
              (23, 2, 1024, 512),      # the CPU tests' shard: no tile fits
              (23, 1, 1024, 512),
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

    def timed(F, C, n_fft, hop):
        L = (F - 1) * hop + n_fft
        y = torch.randn((F, C, n_fft), generator=gen, device="cuda")
        # library yardstick: col2im with kernel (1, n_fft), stride (1, hop)
        # is the same overlap-add, on fold's own channel-major layout
        yf = y.permute(1, 2, 0).reshape(1, C * n_fft, F).contiguous()

        def fold():
            return torch.nn.functional.fold(yf, output_size=(1, L),
                                            kernel_size=(1, n_fft),
                                            stride=(1, hop))
        ref = cuda_ola.overlap_add_plain(y, hop)
        f_err = float((fold()[0, :, 0, :].T - ref).abs().max())
        if f_err > 1e-5:
            fail(f"fold yardstick disagrees with the plain OLA: {f_err}")
        ms, plain_ms, library_ms = time_turns(torch, [
            lambda: cuda_ola.overlap_add_cuda(y, hop),
            lambda: cuda_ola.overlap_add_plain(y, hop), fold])
        read_b, write_b = F * C * n_fft * 4, L * C * 4
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=(read_b + write_b) / HBM_BYTES_PER_S * 1e3,
                 copy_ms=copy_ms(torch, read_b + write_b))
        log(f"ola {(F, C, n_fft, hop)}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.fold {library_ms:.4f} ms; "
            f"{read_b / 1e6:.2f} MB read + {write_b / 1e6:.2f} MB written, "
            f"bound {r['bound_ms']:.4f} ms at 3.35 TB/s (H100 SXM HBM3, data "
            f"sheet), {100 * r['bound_ms'] / ms:.0f}% of it; a copy moving "
            f"as many bytes {r['copy_ms']:.4f} ms")
        return r

    # the shard shapes first: the sharded path is the kernel's main path
    shard = timed(256, 2, 4096, 2048)
    weights = timed(256, 1, 4096, 2048)
    prod = timed(1024, 2, 4096, 2048)
    norm = timed(1024, 1, 4096, 2048)
    log("ola at the shard shapes: at 8-13 MB a launch the fixed cost of a "
        "launch (grid fill and drain, the first bytes' latency) is most of "
        "the time; compare each with the copy of the same bytes beside it")
    return dict(max_abs_err=worst, ms=shard["ms"], plain_ms=shard["plain_ms"],
                bound_ms=shard["bound_ms"], library_ms=shard["library_ms"],
                copy_ms=shard["copy_ms"], shape="[256, 2, 4096] hop 2048",
                other_shapes={"[256, 1, 4096] hop 2048": weights,
                              "[1024, 2, 4096] hop 2048": prod,
                              "[1024, 1, 4096] hop 2048": norm})


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
        (1024, 1, 4096, 2048, 1024, "floor8"),  # the adaptive mono path's
        (1024, 1, 4096, 2048, 267, "floor8"),   # and its partial last chunk
        # the last chunks of the 60 s stereo paths: adaptive, apply_eq
        # (pad on), apply_residual_eq (no pad)
        (1024, 2, 4096, 2048, 382, "floor8"),
        (1024, 2, 4096, 2048, 383, "eps"),
        (1024, 2, 4096, 2048, 381, "eps"),
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
            cms = copy_ms(torch, nbytes)
            timed[(F, transport)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, copy_ms=cms)
            log(f"chunk tail {(F, C, n_fft, hop)} {transport}: kernel "
                f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB"
                f" at 3.35 TB/s, {100 * bound_ms / ms:.0f}% of it; a copy "
                f"moving as many bytes {cms:.4f} ms); "
                f"chunk_tail_plain, PR 1's composed chunk tail (the main "
                f"path's before-figure) {plain_ms:.4f} ms; the same "
                f"composition with the standalone OLA kernel {unfused_ms:.4f}"
                f" ms")
    # the adaptive processor's variants (floor8, f32), stereo and mono
    for C in (2, 1):
        F, n_fft, hop = 1024, 4096, 2048
        a = tail_inputs(torch, gen, F, C, n_fft, hop)
        plain_ms, ms = time_turns(torch, [
            lambda: cuda_ola.chunk_tail_plain(n_valid=F, norm="floor8", **a),
            lambda: cuda_ola.chunk_tail_cuda(n_valid=F, norm="floor8", **a)])
        nbytes = tail_bytes(F, C, n_fft, hop, "f32")
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"chunk tail {(F, C, n_fft, hop)} floor8 f32 (the adaptive "
            f"path's): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, {100 * bound_ms / ms:.0f}%"
            f" of it); chunk_tail_plain {plain_ms:.4f} ms")
    return dict(max_abs_err=worst, library_ms=None,
                **timed[(1024, "pcm24")],
                other_shapes={f"[{F}, 2, 4096] hop 2048 pcm24":
                              timed[(F, "pcm24")] for F in (512, 256)})


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
    """Set every launch count to 0, just before a path is driven."""
    cuda_ola.overlap_add_cuda.launches = 0
    cuda_ola.chunk_tail_cuda.launches = 0
    cuda_ola.chunk_tail_cuda.by_variant.clear()
    cuda_ola.chunk_tail_cuda.by_frames.clear()
    cuda_ola.chunk_tail_batched_cuda.launches = 0
    cuda_ola.chunk_tail_batched_cuda.by_variant.clear()


def counts_of(cuda_ola) -> dict:
    return {"chunk_tail": cuda_ola.chunk_tail_cuda.launches,
            "overlap_add": cuda_ola.overlap_add_cuda.launches,
            "chunk_tail_batched": cuda_ola.chunk_tail_batched_cuda.launches}


def tail_frames(cuda_ola, c: dict) -> dict:
    """c with the chunk-tail launches by chunk size (frames) beside it:
    the ramp's 256- and 512-frame chunks and the full ones."""
    by = cuda_ola.chunk_tail_cuda.by_frames
    return dict(c, chunk_tail_by_frames={str(f): by[f] for f in sorted(by)})


def read_counts(cuda_ola, chunks: int, what: str, variant=None) -> dict:
    """The launch counts just after a single-file path was driven; fails
    unless it made one fused chunk-tail launch per chunk, no standalone
    overlap-add and no batched launch, and (variant given) every launch
    was that (norm, transport, channels) variant of the kernel."""
    c = counts_of(cuda_ola)
    if c["chunk_tail"] == 0 or c["chunk_tail"] != chunks \
            or c["overlap_add"] != 0 or c["chunk_tail_batched"] != 0:
        fail(f"{what}: launches {c} over {chunks} chunks (expected one "
             f"chunk-tail launch per chunk and nothing else)")
    by = dict(cuda_ola.chunk_tail_cuda.by_variant)
    if variant is not None and by != {variant: chunks}:
        fail(f"{what}: chunk-tail variants {by}, expected only {variant}")
    return tail_frames(cuda_ola, c)


def read_batch_counts(cuda_ola, chunks: int, what: str) -> dict:
    """The launch counts just after a batch was driven: one batched
    launch per batch chunk, every one ("eps", "pcm24", 2), and no
    single-file launch."""
    c = counts_of(cuda_ola)
    by = dict(cuda_ola.chunk_tail_batched_cuda.by_variant)
    if c != {"chunk_tail": 0, "overlap_add": 0,
             "chunk_tail_batched": chunks} or chunks == 0 \
            or by != {("eps", "pcm24", 2): chunks}:
        fail(f"{what}: launches {c}, variants {by} over {chunks} batch "
             f"chunks (expected one batched launch per chunk only)")
    return c


def pcm_of(audio, path) -> np.ndarray:
    """A PCM_24 file's samples as integers [n, C]."""
    y, _ = audio.read(path)
    return np.rint(y * 8388608.0).astype(np.int64)


def adaptive_bound(n: int, n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Tolerance [n, 1] between a card and a CPU run of the adaptive
    processor over n samples: 1e-5, plus 2e-7/win[k] on the first and the
    last hop of its stream (sample 0 to the last in-range frame's end).
    One frame alone covers those hops, so a sample k from the stream's end
    is z*win/win^2 = z/win[k], and an irFFT difference e between cuFFT and
    the CPU's FFT comes out as e/win[k]. (The last hop lies past the file's
    end unless the last frame that fits ends short of it.)"""
    b = np.full(n, 1e-5)
    extra = 2e-7 / np.maximum(np.hanning(n_fft)[:hop], 1e-30)
    end = (n_frames - 1) * hop + n_fft         # hop | n_fft/2: base is 0
    for k in range(1, hop):
        for pos in (k, end - 1 - k):
            if 0 <= pos < n:
                b[pos] += extra[k]
    return b[:, None]


def adaptive_paths(torch, cuda_ola, audio, adaptive, x, ip, tmp) -> dict:
    """Phase 9. x: the long programme; ip: the 60 s stereo WAV."""
    pa = adaptive.AdaptiveParams()
    launches = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(cuda_ola)
        t0 = time.perf_counter()
        y, info = adaptive.process_array(x, SR, pa, frames_per_chunk=1024,
                                         device="cuda")
        wall = time.perf_counter() - t0
        chunks = -(-info["n_frames"] // 1024)
        counts = read_counts(cuda_ola, chunks, f"adaptive {run} run",
                             ("floor8", "f32", 2))
        launches.setdefault("adaptive", counts)
        alpha, states = info["alpha"], info["states"]
        n_mid = int(np.sum((alpha > 0) & (alpha < 1)))
        if y.shape != x.shape or not np.all(np.isfinite(y)):
            fail(f"adaptive output shape {y.shape} or non-finite values")
        if set(np.unique(states)) != {1, 2} or n_mid == 0:
            fail(f"adaptive path: states {np.unique(states)}, {n_mid} "
                 f"frames with 0 < alpha < 1")
        if np.max(np.abs(y)) > 0.999 + 1e-6:
            fail("adaptive output exceeds the 0.999 peak limit")
        log(f"adaptive path ({run}): {info['n_frames']} frames, {chunks} "
            f"chunks, {counts['chunk_tail']} chunk-tail launches (all floor8"
            f"/f32/C=2), {counts['overlap_add']} overlap-add launches, "
            f"threshold {info['optimal_threshold']:.3f} dBFS, C2 ratio "
            f"{info['c2_ratio']:.4f}, {info['switch_count']} switches, "
            f"{n_mid} frames with 0 < alpha < 1, pre-attenuation "
            f"{info['atten_db']:.2f} dB, wall {wall:.3f} s, realtime factor "
            f"{len(x) / SR / wall:.2f}x, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, stages "
            f"{info['timings']}")

    # file to file against the port's CPU run: stereo 48 kHz, then a MONO
    # 44.1 kHz file (the first channel's samples at another rate)
    x60, _ = audio.read(ip)
    mono_ip = os.path.join(tmp, "mono44.wav")
    audio.write(mono_ip, x60[:60 * 44100, :1], 44100, subtype="PCM_24")
    for name, path, ch in (("adaptive_file", ip, 2),
                           ("adaptive_mono", mono_ip, 1)):
        outs = {}
        for dev in ("cuda", "cpu"):
            op = os.path.join(tmp, f"{name}_{dev}.wav")
            cp = os.path.join(tmp, f"{name}_{dev}.csv")
            if dev == "cuda":
                reset_counts(cuda_ola)
            st = adaptive.process(path, op, pa, state_csv_path=cp,
                                  frames_per_chunk=1024, device=dev)
            if dev == "cuda":
                launches[name] = read_counts(
                    cuda_ola, -(-st["n_frames"] // 1024), name,
                    ("floor8", "f32", ch))
            outs[dev] = (st, audio.read(op)[0], read_adaptive_csv(cp))
        (st_g, y_g, csv_g), (st_c, y_c, csv_c) = outs["cuda"], outs["cpu"]
        meta = audio.info(os.path.join(tmp, f"{name}_cuda.wav"))
        if (meta.frames, meta.channels) != (st_g["total"], ch) \
                or meta.subtype != "PCM_24":
            fail(f"{name}: wrote {meta}")
        d = np.abs(y_g - y_c)
        bound = adaptive_bound(len(d), st_g["n_frames"], pa.n_fft, pa.hop)
        # one PCM_24 step on top: both files are quantised
        if not np.all(d <= bound + 2.0 ** -23):
            fail(f"{name}: card vs CPU max|d| {d.max()} over the bound "
                 f"(1e-5 off the stream's edge hops)")
        inner = d[pa.hop:len(d) - pa.hop]
        if abs(st_g["optimal_threshold"] - st_c["optimal_threshold"]) > 1e-3:
            fail(f"{name}: threshold {st_g['optimal_threshold']} on the card,"
                 f" {st_c['optimal_threshold']} on the CPU")
        if csv_g["state"] != csv_c["state"] \
                or st_g["switch_count"] != st_c["switch_count"]:
            fail(f"{name}: the state column differs between card and CPU")
        n_c2 = csv_g["state"].count("C2")
        if not 0 < n_c2 < len(csv_g["state"]):
            fail(f"{name}: {n_c2} C2 frames of {len(csv_g['state'])}")
        log(f"{name} ({ch} ch, {st_g['sr']} Hz, {st_g['total']} samples): "
            f"{launches[name]['chunk_tail']} chunk-tail launches (floor8/f32/"
            f"C={ch}); card vs CPU max|d| {d[:pa.hop].max():.3e} on the first"
            f" hop, {d[-pa.hop:].max():.3e} on the last, {inner.max():.3e} "
            f"between them (output peak {float(np.abs(y_c).max()):.4f}); "
            f"threshold "
            f"{st_g['optimal_threshold']:.6f} vs "
            f"{st_c['optimal_threshold']:.6f} dBFS (|d| "
            f"{abs(st_g['optimal_threshold'] - st_c['optimal_threshold']):.1e}"
            f"); C1/C2 {len(csv_g['state']) - n_c2}/{n_c2} and the state "
            f"column equal; card wall {st_g['timings']['wall_s']:.3f} s, "
            f"stages {st_g['timings']}")
    return launches


def read_adaptive_csv(path) -> dict:
    """The adaptive state CSV's state and alpha columns."""
    import csv
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return dict(state=[r["state"] for r in rows],
                alpha=np.array([float(r["alpha"]) for r in rows]))


def edges_agree(a: np.ndarray, b: np.ndarray, n_fft: int, hop: int) -> str:
    """Two renders of one uncropped stream, PCM_24 ints [n, C]: within 4
    LSB off the edge hops; on them, where the output is z/win[k] k samples
    from the end, within 4 LSB + 1e-7/win[k] or saturated alike. Returns
    a description, or fails."""
    n = len(a)
    if len(b) != n:
        fail(f"render lengths differ: {n} and {len(b)}")
    d = np.abs(a - b)
    inner = d[hop:n - hop].max() if n > 2 * hop else 0
    if inner > 4:
        fail(f"renders differ by {inner} LSB off the edge hops (limit 4)")
    win = np.maximum(np.hanning(n_fft)[:hop], 1e-30)
    bound = (4 + 8388608 * 1e-7 / win)[:, None]
    worst = 0
    for sl, bd in ((slice(0, hop), bound), (slice(n - hop, n), bound[::-1])):
        sat = (np.abs(a[sl]) >= 8388607) | (np.abs(b[sl]) >= 8388607)
        if not np.all(np.sign(a[sl][sat]) == np.sign(b[sl][sat])):
            fail("an edge sample saturates with opposite signs")
        if not np.all((d[sl] <= bd) | sat):
            fail(f"edge hop differs beyond 4 LSB + 1e-7/win[k]: "
                 f"{d[sl].max()} LSB")
        worst = max(worst, int(np.where(sat, 0, d[sl]).max()))
    edge_peak = int(max(np.abs(a[:hop]).max(), np.abs(a[n - hop:]).max()))
    return (f"{inner} LSB off the edge hops, {worst} LSB on them "
            f"(edge peak {edge_peak} of 8388607)")


def edge_peak(x: np.ndarray, gain_bins: np.ndarray, n_fft: int, hop: int,
              n_frames: int) -> tuple:
    """The largest sample on the two edge hops of an uncropped, unpadded
    gain stream over x [n, C], rebuilt in float64: there the output is
    z*win[k]/(win[k]**2 + 1e-12), z the frame's filtered irFFT. Returns
    (its magnitude, win[k]/(win[k]**2 + 1e-12) of the sample k that
    carries it): an error e of z moves that sample by e times the second."""
    win = np.hanning(n_fft)
    amp = win / (win * win + 1e-12)
    best = (0.0, 0.0)
    for f0, sl in ((0, slice(0, hop)),
                   ((n_frames - 1) * hop, slice(n_fft - hop, n_fft))):
        fr = x[f0:f0 + n_fft].astype(np.float64) * win[:, None]
        z = np.fft.irfft(np.fft.rfft(fr, axis=0)
                         * np.asarray(gain_bins, np.float64)[:, None],
                         n=n_fft, axis=0)
        y = np.abs(z * amp[:, None])[sl]
        k = int(np.argmax(y.max(axis=1)))
        if y[k].max() > best[0]:
            best = (float(y[k].max()), float(amp[sl][k]))
    return best


def eq_paths(torch, cuda_ola, audio, eq, standard, x60, tmp) -> dict:
    """Phases 10 and 11: both appliers against the CPU run, then an
    interrupted and resumed apply_eq."""
    import csv
    n_fft, hop = 4096, 2048
    launches = {}
    eq_csv = os.path.join(tmp, "curve.csv")
    with open(eq_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["freq_hz", "delta_db_raw", "delta_db_smooth"])
        for fr in np.geomspace(20, 20000, 96):
            w.writerow([fr, 0.0, 4.0 * np.sin(np.log10(fr) * 2.0)])
    diff_csv = os.path.join(tmp, "diff.csv")
    freqs = np.fft.rfftfreq(n_fft, 1 / SR)
    np.savetxt(diff_csv, np.stack(
        [freqs, 3.0 * np.sin(np.log10(np.maximum(freqs, 1.0)) * 3.0)], 1),
        delimiter=",", header="freq_hz,delta_db_base_minus_cand", comments="")

    # apply_eq: FLAC to FLAC, pad on, a silent frame at both ends
    xs = x60.copy()
    xs[:n_fft] = 0.0
    xs[-2 * n_fft:] = 0.0
    sip = os.path.join(tmp, "eq_in.flac")
    audio.write(sip, xs, SR, subtype="PCM_24")
    res = {}
    for dev in ("cuda", "cpu"):
        op = os.path.join(tmp, f"eq_{dev}.flac")
        if dev == "cuda":
            reset_counts(cuda_ola)
        res[dev] = eq.apply_eq(sip, op, eq_csv, device=dev)
        if dev == "cuda":
            launches["apply_eq"] = read_counts(
                cuda_ola, res[dev]["chunks"], "apply_eq", ("eps", "pcm24", 2))
    rg, rc = res["cuda"], res["cpu"]
    F = rg["n_frames"]
    a, b = pcm_of(audio, rg["out_path"]), pcm_of(audio, rc["out_path"])
    if F != (len(xs) + n_fft - n_fft) // hop + 1 \
            or len(a) != F * hop + n_fft - hop or rg["transport"] != "pcm24":
        fail(f"apply_eq: {F} frames, {len(a)} samples, {rg['transport']}")
    what = edges_agree(a, b, n_fft, hop)
    rel = abs(rg["peak_seen"] - rc["peak_seen"]) / rc["peak_seen"]
    if rel > 1e-5:
        fail(f"apply_eq: peak_seen {rg['peak_seen']} on the card, "
             f"{rc['peak_seen']} on the CPU")
    if rg["gain_protected_path"] or rg["peak_seen"] > 0.99:
        fail(f"apply_eq: peak {rg['peak_seen']} on a programme below 0.2")
    log(f"apply_eq (60 s FLAC to FLAC, pad on, pcm24): {F} frames, "
        f"{launches['apply_eq']['chunk_tail']} chunk-tail launches, "
        f"{len(a)} samples = F*hop + n_fft - hop; card vs CPU {what}; "
        f"peak_seen {rg['peak_seen']:.6f} vs {rc['peak_seen']:.6f} (rel "
        f"{rel:.1e}); card stages {rg['timings']}")
    # the same call 20 dB up: the render clips, so the gain-protect copy
    # (a host loop over 30 s blocks: FLAC decode, scale, FLAC encode) runs
    rgp = eq.apply_eq(sip, os.path.join(tmp, "eq_hot.flac"), eq_csv,
                      global_gain_db=20.0, device="cuda")
    if not rgp["gain_protected_path"] or not rgp["peak_seen"] > 0.99:
        fail(f"apply_eq: no gain-protect copy at peak {rgp['peak_seen']}")
    gp = pcm_of(audio, rgp["gain_protected_path"])
    if len(gp) != len(a) or np.abs(gp).max() > 0.99 * 8388608 + 1:
        fail(f"apply_eq: gain-protect copy peaks at {np.abs(gp).max()}")
    log(f"apply_eq +20 dB: peak_seen {rgp['peak_seen']:.4f}, gain-protect "
        f"copy at scale {rgp['gain_protect_scale']:.4f} written in "
        f"{rgp['timings']['gain_protect_s']} s (stream "
        f"{rgp['timings']['wall_s']} s)")

    # apply_residual_eq --safe: WAV to WAV, no pad, signal up to both ends
    rip = os.path.join(tmp, "res_in.wav")
    audio.write(rip, x60, SR, subtype="PCM_24")
    res = {}
    for dev in ("cuda", "cpu"):
        op = os.path.join(tmp, f"res_{dev}.wav")
        if dev == "cuda":
            reset_counts(cuda_ola)
        res[dev] = eq.apply_residual_eq(rip, op, diff_csv, safe=True,
                                        device=dev)
        if dev == "cuda":
            launches["apply_residual_eq"] = read_counts(
                cuda_ola, res[dev]["chunks"], "apply_residual_eq",
                ("eps", "pcm24", 2))
    rg, rc = res["cuda"], res["cpu"]
    F = rg["n_frames"]
    a, b = pcm_of(audio, rg["out_path"]), pcm_of(audio, rc["out_path"])
    if F != (len(x60) - n_fft) // hop + 1 or len(a) != F * hop + n_fft - hop:
        fail(f"apply_residual_eq: {F} frames, {len(a)} samples")
    what = edges_agree(a, b, n_fft, hop)
    interior_peak = np.abs(a[hop:len(a) - hop]).max() / 8388608.0
    dpk = abs(rg["peak_seen"] - rc["peak_seen"])
    rel = dpk / rc["peak_seen"]
    on_edge = rg["peak_seen"] > interior_peak * 1.001 + 2.0 ** -23
    if on_edge:
        # the peak is an edge sample z*win[k]/(win[k]**2 + 1e-12): held to
        # the 1e-7 of z that edges_agree allows, scaled as that sample is
        res_freq, res_db = eq.load_residual_csv(diff_csv)
        eq_lin, _ = eq.build_eq_from_residual_safe(
            freqs, res_freq, eq.smooth_on_logfreq(res_freq, res_db, win=61),
            clamp_lo=-1.0, clamp_hi=1.0, hf_start=3000.0)
        pk64, amp = edge_peak(audio.read(rip)[0], eq_lin, n_fft, hop, F)
        limit = 1e-7 * amp
        if abs(rc["peak_seen"] - pk64) > limit:
            fail(f"apply_residual_eq: peak_seen {rc['peak_seen']} on the "
                 f"CPU, {pk64} rebuilt in float64 (limit {limit:.3e})")
    else:
        limit = 1e-5 * rc["peak_seen"]
    if dpk > limit:
        fail(f"apply_residual_eq: peak_seen {rg['peak_seen']} on the card, "
             f"{rc['peak_seen']} on the CPU (limit {limit:.3e}; peak on an "
             f"edge: {on_edge})")
    log(f"apply_residual_eq --safe (60 s WAV to WAV, no pad): {F} frames, "
        f"{launches['apply_residual_eq']['chunk_tail']} chunk-tail launches,"
        f" {len(a)} samples = F*hop + n_fft - hop; card vs CPU {what}; "
        f"peak_seen {rg['peak_seen']:.6f} vs {rc['peak_seen']:.6f} (|d| "
        f"{dpk:.3e}, rel {rel:.1e}, limit {limit:.3e}: "
        + (f"the peak is an edge sample, 1e-7 of z times {amp:.4e}"
           if on_edge else "1e-5 relative, the peak is interior")
        + f"; interior peak {interior_peak:.6f}); card stages {rg['timings']}")

    # phase 11: apply_eq with a checkpoint, stopped and rerun
    kw = dict(global_gain_db=0.0, frames_per_chunk=256, device="cuda")
    uop, rop = os.path.join(tmp, "equ.flac"), os.path.join(tmp, "eqr.flac")
    ck = os.path.join(tmp, "eq_ck.npz")
    ures = eq.apply_eq(sip, uop, eq_csv, **kw)

    class SinkStopped(Exception):
        pass

    writes = [0]
    write_raw = standard._RawWav.write_raw

    def stop_on_third(self, raw):
        writes[0] += 1
        if writes[0] > 2:
            raise SinkStopped()
        return write_raw(self, raw)

    standard._RawWav.write_raw = stop_on_third
    try:
        eq.apply_eq(sip, rop, eq_csv, checkpoint_path=ck, checkpoint_every=2,
                    **kw)
    except SinkStopped:
        pass
    else:
        fail("EQ resume: the sink's exception did not stop the run")
    finally:
        standard._RawWav.write_raw = write_raw
    if not os.path.exists(ck) or not os.path.exists(rop + ".part.wav"):
        fail("EQ resume: no checkpoint or no staged WAV after the stop")
    reset_counts(cuda_ola)
    rres = eq.apply_eq(sip, rop, eq_csv, checkpoint_path=ck,
                       checkpoint_every=2, **kw)
    launches["eq_resume"] = read_counts(cuda_ola, rres["chunks"],
                                        "EQ resume", ("eps", "pcm24", 2))
    if os.path.exists(ck) or os.path.exists(rop + ".part.wav"):
        fail("EQ resume: the checkpoint or the staged WAV was left behind")
    if not 0 < rres["chunks"] < ures["chunks"]:
        fail(f"EQ resume: the rerun took {rres['chunks']} chunks of "
             f"{ures['chunks']}: it did not resume mid-stream")
    if open(rop, "rb").read() != open(uop, "rb").read() \
            or rres["peak_seen"] != ures["peak_seen"]:
        fail("EQ resume: the output or its peak differs from the "
             "uninterrupted run's")
    log(f"EQ resume: stopped on write 3, resumed with {rres['chunks']} of "
        f"{ures['chunks']} chunks left; out.flac ({os.path.getsize(rop)} "
        f"bytes) equals the uninterrupted run's byte for byte, peak_seen "
        f"equal; checkpoint and staged WAV removed")
    return launches


def match_music(seconds: float, seed: int) -> np.ndarray:
    """Broadband 'music' for the match workflow: filtered noise under a
    percussive envelope whose level swings across the gate threshold."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    noise = lfilter([1.0], [1.0, -0.93], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    amp = np.full(n, 0.004, np.float32)
    pos = 0
    while pos < n:
        dur = int(SR * rng.uniform(0.2, 0.7))
        peak = 0.05 * 10 ** (0.4 * rng.standard_normal())
        seg = min(dur, n - pos)
        amp[pos:pos + seg] += peak * np.exp(-np.arange(seg) / (0.3 * SR))
        pos += dur
    x = amp * noise
    return np.clip(np.stack([x, 0.95 * x], 1), -1, 1).astype(np.float32)


def colorize(x: np.ndarray, gains_db_at) -> np.ndarray:
    """A fixed spectral coloration, interpolated on the log-f axis."""
    n = len(x)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    fs, dbs = zip(*gains_db_at)
    g = 10 ** (np.interp(np.log10(np.maximum(freqs, 1)),
                         np.log10(fs), dbs) / 20.0)
    y = np.empty_like(x)
    for c in range(x.shape[1]):
        y[:, c] = np.fft.irfft(np.fft.rfft(x[:, c]) * g, n)
    return y.astype(np.float32)


def match_path(torch, cuda_ola, audio, standard, seed: int, tmp) -> dict:
    """Phase 12: the whole match workflow on the card."""
    from tomatis_tpu_torch.analysis import gridgate
    from tomatis_tpu_torch.models import workflow
    true_t, true_hyst, dev_gain = -28.0, 2.0, -4.0
    color = [(30, -4.0), (300, 3.0), (1000, 0.0), (5000, -6.0),
             (16000, -9.0)]
    tilt = dict(c1_low=3.0, c1_high=-3.0, c2_low=-3.0, c2_high=3.0)
    orig = match_music(60.0, seed + 33)
    p_dev = standard.StandardParams(
        gate_ui=50.0, gate_mode="linear", gate_offset=true_t - 50.0,
        hysteresis_db=true_hyst, up_delay_ms=0.0, output_gain_db=dev_gain,
        **tilt)
    dev, _ = standard.process_array(orig, SR, p_dev, device="cuda")
    dev = colorize(dev, color)
    orig_p = os.path.join(tmp, "m_orig.flac")
    dev_p = os.path.join(tmp, "m_device.flac")
    audio.write(orig_p, orig, SR, subtype="PCM_24")
    audio.write(dev_p, np.clip(dev[int(0.3 * SR):], -1, 1), SR,
                subtype="PCM_24")
    outdir = os.path.join(tmp, "match")
    lines = []
    reset_counts(cuda_ola)
    t0 = time.perf_counter()
    rep = workflow.match_device(orig_p, dev_p, outdir, max_minutes=6.0,
                                progress=lines.append, device="cuda",
                                **tilt)
    wall = time.perf_counter() - t0
    # three streams of 2 chunks each; a peak-protected final render adds 2
    protected = "peak_protect_db" in rep["stages"].get("residual", {})
    counts = read_counts(cuda_ola, 8 if protected else 6, "match")
    n_tail = counts["chunk_tail"]
    for ln in lines:
        log(f"match: {ln}")
    for name in ("calibration_v2.json", "state.csv", "layer1.flac",
                 "layer2_eq_curve.csv", "layer2.flac", "diff_spectrum.csv",
                 "matched.flac", "final_diff_spectrum.csv",
                 "match_report.json"):
        if not os.path.exists(os.path.join(outdir, name)):
            fail(f"match: artifact {name} was not written")
    st = rep["stages"]
    if abs(st["calibrate"]["T_raw_dbfs"] - true_t) >= 2.0:
        fail(f"match: T_raw {st['calibrate']['T_raw_dbfs']} dBFS, truth "
             f"{true_t}")
    if not st["layer2"]["music_err_db"] < st["layer1"]["music_err_db"]:
        fail(f"match: layer 2 music_err {st['layer2']['music_err_db']} is "
             f"not under layer 1's {st['layer1']['music_err_db']}")
    if not st["final"]["music_err_db"] < 0.4:
        fail(f"match: final music_err {st['final']['music_err_db']} dB")
    y, _ = audio.read(rep["matched_path"])
    if not np.all(np.isfinite(y)) or np.max(np.abs(y[4096:-4096])) > 0.9901:
        fail("match: the final render's interior clips or is not finite")
    tm = rep["timings"]
    log(f"match (60 s original, device rendition at T {true_t} dBFS, "
        f"{dev_gain} dB, coloured, 0.3 s late): T_raw "
        f"{st['calibrate']['T_raw_dbfs']:.2f} dBFS, hyst "
        f"{st['calibrate']['hyst_db']}, state mismatch "
        f"{st['calibrate']['mismatch']:.4f}; music_err layer 1 "
        f"{st['layer1']['music_err_db']:.3f} dB, layer 2 "
        f"{st['layer2']['music_err_db']:.3f} dB, final "
        f"{st['final']['music_err_db']:.3f} dB; {n_tail} chunk-tail launches"
        f"; wall {wall:.3f} s, stages "
        f"{ {k: v for k, v in tm.items() if k != 'calibrate'} }")
    cal = json.load(open(os.path.join(outdir, "calibration_v2.json")))
    log(f"match calibrate split: {tm['calibrate']}")
    log(f"grid gate (inside calibrate, 60 s): {tm['calibrate']['grid_gate_s']}"
        f" s for the gate of {cal['hyst_db']} dB hysteresis found")

    # the grid gate alone at a 6-minute deployment's size: 8437 frames,
    # 13 gains x 2916 combinations in the lanes
    rng = np.random.default_rng(seed)
    F, B, G = 8437, 13, 2916
    levels = (-45 + 25 * rng.random((B, F))).astype(np.float32)
    tons = (-40 + 20 * rng.random((B, G))).astype(np.float32)
    ups = rng.integers(0, 12001, (B, G)).astype(np.int32)
    tgt = (1 + (rng.random(F) > 0.5)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, _, _ = gridgate.grid_gate_scores(
        levels, np.arange(F) * 2048, tons, tons - 2.0, ups, 1e-5, tgt,
        device="cuda")
    t_grid = time.perf_counter() - t0
    if scores.shape != (B, G) or not np.all(np.isfinite(scores)):
        fail(f"grid gate scores {scores.shape}")
    log(f"grid gate alone, 6-minute size ({F} frames x {B * G} lanes): "
        f"{t_grid:.3f} s ({1e6 * t_grid / F:.1f} us a frame)")
    return {"match": counts}


def declick_path(audio, tmp):
    """Phase 13: planted clicks are found; a clean file passes through."""
    from tomatis_tpu_torch.models import repair
    rng = np.random.default_rng(5)
    n = 10 * SR
    t = np.arange(n) / SR
    clean = (0.3 * np.sin(2 * np.pi * 220 * t)[:, None]
             + 0.001 * rng.standard_normal((n, 2))).astype(np.float32)
    clicks = [12345, 100000, 250007, 400000]
    x = clean.copy()
    x[clicks] += 0.9
    ip, op = os.path.join(tmp, "clicks.wav"), os.path.join(tmp, "fixed.wav")
    audio.write(ip, x, SR, subtype="PCM_24")
    t0 = time.perf_counter()
    st = repair.declick(ip, op, report_csv=os.path.join(tmp, "clicks.csv"))
    wall = time.perf_counter() - t0
    y, _ = audio.read(op)
    if st.get("kept_segments", 0) < len(clicks) or len(y) != n \
            or any(abs(y[c, 0]) > 0.45 for c in clicks):
        fail(f"declick: {st}, repaired peaks "
             f"{[float(abs(y[c, 0])) for c in clicks]}")
    cip, cop = os.path.join(tmp, "clean.wav"), os.path.join(tmp, "clean2.wav")
    audio.write(cip, clean, SR, subtype="PCM_24")
    st2 = repair.declick(cip, cop, k=25.0)
    if st2["hits"] != 0 or not np.array_equal(audio.read(cop)[0],
                                              audio.read(cip)[0]):
        fail(f"declick: the clean file did not pass through: {st2}")
    log(f"declick: {st['hits']} hits, {st['kept_segments']} segments over "
        f"{len(clicks)} planted clicks repaired in {wall:.3f} s (10 s "
        f"stereo); the clean file passes through sample for sample")


def wire_inputs(x: np.ndarray, seed: int) -> list:
    """(name, int32 [n, ch]) of the wire codec's input classes at the
    production chunk length n = 1024*2048 + 2048."""
    n = 1024 * 2048 + 2048
    rng = np.random.default_rng(seed + 100)
    # the programme 8 dB up: about the level the processed output has
    v = np.clip(np.rint(x[:n] * np.float32(2.5) * 8388608.0),
                -8388608, 8388607).astype(np.int32)
    return [("programme", v),
            ("mono", np.ascontiguousarray(v[:, :1])),
            ("16bit_sourced", (v >> 8) << 8),
            ("fullscale_noise",
             rng.integers(-8388608, 8388608, (n, 2)).astype(np.int32)),
            ("silence", np.zeros((n, 2), np.int32))]


def host_ms(fn, n: int = 5) -> float:
    """Median host wall time (ms) of n calls."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def wire_codec_phase(torch, x: np.ndarray, seed: int):
    """Phase 14: the wire codec's device half on the card against its
    host halves, then its times."""
    from tomatis_tpu_torch.io import wirecodec
    from tomatis_tpu_torch.ops import wire
    from tomatis_tpu_torch.utils.pcm import le24_from_i32
    if not wirecodec.available():
        fail("the native wire codec (csrc/wire.cpp) did not build or load")
    small = 50_000
    for name, v in wire_inputs(x, seed):
        n, ch = v.shape
        vd = torch.from_numpy(v).cuda()
        expect = v.astype(np.float32) / np.float32(8388608.0)
        pcm = le24_from_i32(v.reshape(-1))
        notes = []
        for rice in (False, True):
            words, used = wire.pack_device(vd, n, ch, rice)
            torch.cuda.synchronize()
            used = int(used)
            stream = words[:used].cpu().numpy().view(np.uint8)
            if bool(words[used:].any()):
                fail(f"wire {name} rice={rice}: words beyond used are not 0")
            cbuf = wirecodec.encode_i32(v, rice=rice)
            wasted = (int(cbuf[12:16].view(np.uint32)[0]) >> 18) & 0x3FF
            if not wasted and not np.array_equal(stream, cbuf):
                fail(f"wire {name} rice={rice}: pack_device on the card "
                     f"differs from the C++ encoder ({len(stream)} vs "
                     f"{len(cbuf)} bytes)")
            if not np.array_equal(wirecodec.decode_pcm24(stream, n, ch), pcm):
                fail(f"wire {name} rice={rice}: card pack -> C++ "
                     f"decode_pcm24 is not the pcm24 payload")
            # the numpy oracle at a cut it handles quickly
            vs = np.ascontiguousarray(v[:small])
            ws, us = wire.pack_device(vd[:small].contiguous(), small, ch, rice)
            oracle = wire.encode_np(vs, rice=rice, wasted=False)
            got = ws[:int(us)].cpu().numpy().view(np.uint8)
            if not np.array_equal(got, oracle):
                fail(f"wire {name} rice={rice}: pack_device on the card "
                     f"differs from encode_np at n={small}")
            # the host-encoded stream (wasted bits and all) on the card
            b = np.concatenate([cbuf, np.zeros((-len(cbuf)) % 4, np.uint8)])
            f = wire.unpack_device(torch.from_numpy(b).cuda(), n, ch, rice)
            if not np.array_equal(f.cpu().numpy(), expect):
                fail(f"wire {name} rice={rice}: unpack_device on the card "
                     f"of the C++ stream is not the floats")
            f2 = wire.unpack_device(words, n, ch, rice)
            if not np.array_equal(f2.cpu().numpy(), expect):
                fail(f"wire {name} rice={rice}: unpack_device of the card's "
                     f"own stream is not the floats")
            notes.append(f"rice {'on' if rice else 'off'} card "
                         f"{used * 4 / (n * ch):.3f} B/sample"
                         + (f", host {len(cbuf) / (n * ch):.3f} (wasted bits)"
                            if wasted else ""))
        log(f"wire codec {name} [{n}, {ch}]: pack == C++ == encode_np, "
            f"unpack exact, pack -> decode_pcm24 == pcm24 bytes; "
            + "; ".join(notes))

    # times at the production chunk, programme material
    name, v = wire_inputs(x, seed)[0]
    n, ch = v.shape
    vd = torch.from_numpy(v).cuda()
    M = wire.max_words(n, ch)
    for rice in (False, True):
        words, used = wire.pack_device(vd, n, ch, rice)
        used = int(used)
        cbuf = wirecodec.encode_i32(v, rice=rice)
        bd = torch.from_numpy(cbuf.view(np.int32).copy()).cuda()
        pack_ms, unpack_ms = time_turns(torch, [
            lambda: wire.pack_device(vd, n, ch, rice),
            lambda: wire.unpack_device(bd, n, ch, rice)], n=5)
        # each input read once, each output written once: the pack reads
        # the ints and writes its whole fixed-size buffer; the unpack
        # reads the stream and writes the floats
        pack_b = n * ch * 4 + M * 4
        unpack_b = len(cbuf) + n * ch * 4
        enc_ms = host_ms(lambda: wirecodec.encode_i32(v, rice=rice))
        dec_ms = host_ms(lambda: wirecodec.decode_pcm24(cbuf, n, ch))
        log(f"wire codec times, production chunk [{n}, {ch}] programme, rice "
            f"{'on' if rice else 'off'}: pack_device {pack_ms:.3f} ms (byte "
            f"bound {pack_b / HBM_BYTES_PER_S * 1e3:.4f} ms for "
            f"{pack_b / 1e6:.1f} MB), unpack_device {unpack_ms:.3f} ms (byte "
            f"bound {unpack_b / HBM_BYTES_PER_S * 1e3:.4f} ms for "
            f"{unpack_b / 1e6:.1f} MB); stream {used * 4 / (n * ch):.4f} "
            f"B/sample ({used * 4} bytes against {n * ch * 3} of pcm24); C++ "
            f"encode_i32 {enc_ms:.1f} ms, decode_pcm24 {dec_ms:.1f} ms a "
            f"chunk (host wall, median of 5)")


def files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def codecs_alone(audio, in_path: str, out_path: str, tmp: str,
                 block: int, int_read: bool) -> tuple:
    """This script's own timing of the two host codecs of a FLAC-to-FLAC
    run, each alone: decoding the whole input in the stream's blocks on
    one thread, and encoding the whole output from its PCM_24 bytes in 5 s
    pieces (each piece's blocks on the encoder's threads). Returns
    (decode_s, encode_s)."""
    from tomatis_tpu_torch.utils.pcm import le24_from_i32
    t0 = time.perf_counter()
    with audio.AudioFile(in_path, "r") as f:
        read = f.read_int24 if int_read else f.read
        while len(read(block)):
            pass
    decode_s = time.perf_counter() - t0
    with audio.AudioFile(out_path, "r") as f:
        sr, ch = f.samplerate, f.channels
        raw = le24_from_i32(f.read_int24().reshape(-1))
    piece = 5 * sr * ch * 3
    t0 = time.perf_counter()
    with audio.AudioFile(os.path.join(tmp, "alone.flac"), "w", samplerate=sr,
                         channels=ch, subtype="PCM_24") as f:
        for i in range(0, len(raw), piece):
            f.write_raw(raw[i:i + piece])
    encode_s = time.perf_counter() - t0
    return decode_s, encode_s


# One-thread FLAC encode of a PCM_24 FLAC's samples, in a child process
# whose affinity is one CPU (set before the encoder reads its budget, so it
# starts no helper): argv is the tree whose package encodes, the FLAC and
# a scratch directory. Prints the helper budget, the full blocks and the
# seconds of each of three encodes.
ONE_THREAD_ENCODE = r"""
import os, sys, time
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
sys.path.insert(0, sys.argv[1])
from tomatis_tpu_torch.io import audio, flac
from tomatis_tpu_torch.utils.pcm import le24_from_i32
with audio.AudioFile(sys.argv[2], "r") as f:
    sr, ch = f.samplerate, f.channels
    raw = le24_from_i32(f.read_int24().reshape(-1))
secs = []
for _ in range(3):
    t0 = time.perf_counter()
    with flac.FlacWriter(os.path.join(sys.argv[3], "one_thread.flac"), sr,
                         ch, "PCM_24") as w:
        w.write_raw(raw)
    secs.append(time.perf_counter() - t0)
print(flac.encoder_threads(), len(raw) // (3 * ch * flac.BLOCK),
      *secs)
"""


def one_thread_encode_us(root: str, flac_path: str, tmp: str) -> list:
    """Microseconds per 4096-frame block of the package under `root`
    encoding flac_path's samples on one thread, three encodes."""
    p = subprocess.run([sys.executable, "-c", ONE_THREAD_ENCODE, root,
                        flac_path, tmp], capture_output=True, text=True)
    if p.returncode != 0:
        fail(f"one-thread encode under {root}: {p.stderr[-2000:]}")
    threads, blocks, *secs = p.stdout.split()
    if int(threads) != 0:
        fail(f"one-thread encode: a helper budget of {threads} on one CPU")
    return [float(t) / int(blocks) * 1e6 for t in secs]


def thread_paths(torch, cuda_ola, audio, standard, eq, x, stream_alone_s,
                 tmp) -> dict:
    """Phases 15 to 17. x: the long programme; stream_alone_s: the stage
    timers' sum of the warm array run of x (phase 4: no file codec in
    it)."""
    p = standard.StandardParams()
    launches = {}

    # -- 15. the long file ---------------------------------------------------
    # the long programme as a FLAC, a frame of silence at both ends (the
    # EQ render's edges, see the appliers' phase)
    xl = x.copy()
    xl[:4096] = 0.0
    xl[-8192:] = 0.0
    lip = os.path.join(tmp, "long.flac")
    t0 = time.perf_counter()
    audio.write(lip, xl, SR, subtype="PCM_24")
    log(f"long FLAC: {len(xl) / SR:.0f} s written in "
        f"{time.perf_counter() - t0:.3f} s, {os.path.getsize(lip)} bytes")
    del xl
    lop = os.path.join(tmp, "long_pcm24.flac")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ola)
    sp = standard.process(lip, lop, p,
                          state_csv_path=os.path.join(tmp, "long_pcm24.csv"),
                          device="cuda", transport="pcm24")
    launches["long_pcm24"] = read_counts(
        cuda_ola, sp["chunks"], "10-minute pcm24 path", ("eps", "pcm24", 2))
    sp["peak_mem"] = torch.cuda.max_memory_allocated()
    log(f"long FLAC to FLAC, pcm24: {sp['chunks']} chunks, wall "
        f"{sp['wall_seconds']:.3f} s, realtime factor "
        f"{sp['realtime_factor']:.2f}x, stages {sp['timings']}, peak device "
        f"memory {sp['peak_mem'] / 1e9:.3f} GB")

    # -- 16. the threaded pipeline, measured ---------------------------------
    dec_s, enc_s = codecs_alone(audio, lip, lop, tmp, 1024 * 2048, False)
    block_us = one_thread_encode_us(os.path.dirname(os.path.abspath(__file__)),
                                    lop, tmp)
    log(f"FLAC encoder alone, the long PCM_24 output: {enc_s:.3f} s on the "
        f"encoder's threads; one thread (affinity one CPU, no helper) "
        f"{', '.join(f'{u:.1f}' for u in block_us)} us per 4096-frame block "
        f"(three encodes)")
    t = sp["timings"]
    stages = sum(t.values())
    overlap_s = dec_s + enc_s + stream_alone_s - sp["wall_seconds"]
    log(f"threaded pipeline, long FLAC to FLAC on pcm24: wall "
        f"{sp['wall_seconds']:.3f} s; this thread's stage timers {t} (sum "
        f"{stages:.3f} s); alone: decoding the input on one thread "
        f"{dec_s:.3f} s, encoding the output {enc_s:.3f} s, the array run's "
        f"stream stages {stream_alone_s:.3f} s; overlap = decode + encode + "
        f"stream - wall = {overlap_s:.3f}"
        f" s; peak device memory with three chunks in flight "
        f"{sp['peak_mem'] / 1e9:.3f} GB")

    import csv
    eq_csv = os.path.join(tmp, "curve_long.csv")
    with open(eq_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["freq_hz", "delta_db_raw", "delta_db_smooth"])
        for fr in np.geomspace(20, 20000, 96):
            w.writerow([fr, 0.0, 4.0 * np.sin(np.log10(fr) * 2.0)])
    eop = os.path.join(tmp, "long_eq.flac")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ola)
    er = eq.apply_eq(lip, eop, eq_csv, device="cuda")
    launches["long_apply_eq"] = read_counts(
        cuda_ola, er["chunks"], "10-minute apply_eq", ("eps", "pcm24", 2))
    if er["gain_protected_path"] or not 0 < er["peak_seen"] <= 0.99:
        fail(f"long apply_eq: peak_seen {er['peak_seen']}, gain-protect "
             f"{er['gain_protected_path']}")
    edec_s, eenc_s = codecs_alone(audio, lip, eop, tmp, 1024 * 2048, True)
    te = er["timings"]
    log(f"threaded pipeline, long apply_eq FLAC to FLAC (int24 input, "
        f"pcm24): {er['chunks']} chunks, wall {te['wall_s']:.3f} s, stages "
        f"{te}; alone: decoding the input as ints on one thread "
        f"{edec_s:.3f} s, encoding the output {eenc_s:.3f} s; hidden codec "
        f"time >= decode + encode - wall = "
        f"{edec_s + eenc_s - te['wall_s']:.3f} s; peak_seen "
        f"{er['peak_seen']:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # -- 17. convert ---------------------------------------------------------
    from tomatis_tpu_torch.cli import convert as cli_convert
    cw, cf = os.path.join(tmp, "conv.wav"), os.path.join(tmp, "conv.flac")
    src = lop
    t0 = time.perf_counter()
    if cli_convert.main(["-i", src, "-o", cw]) != 0 \
            or cli_convert.main(["-i", cw, "-o", cf]) != 0:
        fail("convert exited non-zero")
    conv_s = time.perf_counter() - t0
    with audio.AudioFile(src, "r") as fa, audio.AudioFile(cf, "r") as fb, \
            audio.AudioFile(cw, "r") as fc:
        va, vb, vc = fa.read_int24(), fb.read_int24(), fc.read_int24()
    if not (np.array_equal(va, vb) and np.array_equal(va, vc)):
        fail("convert: FLAC -> WAV -> FLAC changed samples")
    log(f"convert: FLAC -> WAV -> FLAC through the int24 copy keeps all "
        f"{len(va)} frames ({conv_s:.3f} s for both)")
    return launches


def batched_tail_inputs(torch, gen, B, F, C, n_fft, hop, n_valid) -> dict:
    """Batched chunk-tail inputs on the card: B lanes of tail_inputs'
    kind, n_valid an int32 [B] tensor; windows and gain shared."""
    a = tail_inputs(torch, gen, F, C, n_fft, hop)
    tail = n_fft - hop
    return dict(
        a, z=0.05 * torch.randn((B, F, C, n_fft), generator=gen,
                                device="cuda"),
        out_tail=0.05 * torch.randn((B, tail, C), generator=gen,
                                    device="cuda"),
        w_tail=torch.rand((B, tail), generator=gen, device="cuda"),
        n_valid=torch.tensor(n_valid, dtype=torch.int32, device="cuda"))


def batched_tail_bytes(B, F, C, n_fft, hop, transport) -> int:
    """Bytes the batched chunk tail must move: each lane's frames, tails
    and outputs (tail_bytes less the shared windows and gain), the shared
    inputs once, and each lane's n_valid."""
    shared = 4 * 2 * n_fft + (4 if transport == "pcm24" else 0)
    return B * (tail_bytes(F, C, n_fft, hop, transport) - shared) \
        + shared + 4 * B


def check_batched_tail(torch, cuda_ola):
    """Phase 18 (a): the batched kernel vs chunk_tail_batched_plain, bit for
    bit in every output; B = 1 vs chunk_tail_cuda; times at B = 1, 4, 8."""
    names = ("out", "peaks", "pcm", "ola_carry", "w_carry")

    def same(got, ref, what):
        for name, g, r in zip(names, got, ref):
            if (g is None) != (r is None):
                fail(f"batched chunk tail {name} presence differs at {what}")
            if r is not None and (g.shape != r.shape or g.dtype != r.dtype
                                  or not torch.equal(g, r)):
                fail(f"batched chunk tail {name} differs at {what}")

    cases = [  # B, F, C, n_fft, hop, n_valid per lane, norm
        (1, 1024, 2, 4096, 2048, [1024], "eps"),
        (2, 1024, 2, 4096, 2048, [1024, 700], "eps"),   # phase 28's B
        (4, 1024, 2, 4096, 2048, [1024, 0, 700, 1024], "eps"),
        (8, 1024, 2, 4096, 2048, [1024, 0, 700, 1024, 1, 1024, 512, 0],
         "eps"),
        (3, 1024, 1, 4096, 2048, [1024, 267, 0], "floor8"),   # C=1
        (3, 37, 2, 300, 150, [30, 0, 37], "floor8"),   # hop % 4: scalar loop
        (3, 16, 3, 512, 256, [16, 0, 9], "eps"),       # C=3: scalar loop
    ]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, F, C, n_fft, hop, n_valid, norm in cases:
        a = batched_tail_inputs(torch, gen, B, F, C, n_fft, hop, n_valid)
        for transport in ("f32", "pcm24"):
            got = cuda_ola.chunk_tail_batched_cuda(norm=norm,
                                                   transport=transport, **a)
            ref = cuda_ola.chunk_tail_batched_plain(norm=norm,
                                                    transport=transport, **a)
            torch.cuda.synchronize()
            same(got, ref, (B, F, C, n_fft, hop, n_valid, norm, transport))
        log(f"batched chunk tail B={B} {(F, C, n_fft, hop)} n_valid "
            f"{n_valid} {norm}: f32 and pcm24 bit-exact in every output")
    for nv in (1024, 700):
        a = batched_tail_inputs(torch, gen, 1, 1024, 2, 4096, 2048, [nv])
        for transport in ("f32", "pcm24"):
            got = cuda_ola.chunk_tail_batched_cuda(transport=transport, **a)
            one = cuda_ola.chunk_tail_cuda(
                a["z"][0], a["win"], a["win2"], nv, a["out_tail"][0],
                a["w_tail"][0], a["gain_lin"], transport=transport)
            torch.cuda.synchronize()
            same([None if g is None else g[0] for g in got], one,
                 ("B=1 vs chunk_tail_cuda", nv, transport))
    log("batched chunk tail B=1 equals chunk_tail_cuda bit for bit "
        "(n_valid 1024 and 700, f32 and pcm24)")

    timed = {}
    F, C, n_fft, hop = 1024, 2, 4096, 2048
    for B in (1, 4, 8):
        a = batched_tail_inputs(torch, gen, B, F, C, n_fft, hop, [F] * B)
        lanes = [dict(z=a["z"][b], win=a["win"], win2=a["win2"], n_valid=F,
                      out_tail=a["out_tail"][b], w_tail=a["w_tail"][b],
                      gain_lin=a["gain_lin"]) for b in range(B)]

        def singles():
            for kw in lanes:
                cuda_ola.chunk_tail_cuda(transport="pcm24", **kw)
        plain_ms, singles_ms, ms = time_turns(torch, [
            lambda: cuda_ola.chunk_tail_batched_plain(transport="pcm24", **a),
            singles,
            lambda: cuda_ola.chunk_tail_batched_cuda(transport="pcm24",
                                                     **a)])
        nbytes = batched_tail_bytes(B, F, C, n_fft, hop, "pcm24")
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        timed[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        log(f"batched chunk tail B={B} {(F, C, n_fft, hop)} pcm24: kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
            f"3.35 TB/s, {100 * bound_ms / ms:.0f}% of it; a copy moving as "
            f"many bytes {copy_ms(torch, nbytes):.4f} ms); {B} single-file "
            f"launches in a row {singles_ms:.4f} ms; "
            f"chunk_tail_batched_plain {plain_ms:.4f} ms")
    return dict(max_abs_err=0.0, library_ms=None, **timed[8])


def lanes_codecs_alone(audio, ins, outs, tmp) -> tuple:
    """This script's own timing of the batch's host codecs alone, one
    thread per lane, all lanes side by side: decoding every input, and
    encoding every output from its PCM_24 bytes in 5 s pieces (with the
    encoder's helper threads, one budget over the lanes). Returns
    (decode_s, encode_s), each the wall of all lanes together."""
    from tomatis_tpu_torch.utils.pcm import le24_from_i32

    def decode(path):
        with audio.AudioFile(path, "r") as f:
            while len(f.read(1024 * 2048)):
                pass

    raws = []
    for path in outs:
        with audio.AudioFile(path, "r") as f:
            raws.append((f.samplerate, f.channels,
                         le24_from_i32(f.read_int24().reshape(-1))))

    def encode(i):
        sr, ch, raw = raws[i]
        piece = 5 * sr * ch * 3
        with audio.AudioFile(os.path.join(tmp, f"alone{i}.flac"), "w",
                             samplerate=sr, channels=ch,
                             subtype="PCM_24") as f:
            for k in range(0, len(raw), piece):
                f.write_raw(raw[k:k + piece])

    with concurrent.futures.ThreadPoolExecutor(len(ins)) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode, ins))
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(pool.map(encode, range(len(outs))))
        encode_s = time.perf_counter() - t0
    return decode_s, encode_s


def batch_path(torch, cuda_ola, audio, standard, x, tmp) -> dict:
    """Phase 18 (b): eight FLAC lanes through process_batch on the card,
    B = 8 and B = 4, each lane against its single-file run."""
    from tomatis_tpu_torch.io.flac import encoder_threads
    from tomatis_tpu_torch.parallel import batch
    p = standard.StandardParams()
    seconds = [90, 150, 105, 135, 120, 97, 142, 113]
    ins = []
    for i, sec in enumerate(seconds):
        n = min(int(sec * SR), len(x))
        off = (i * 37 * SR) % max(1, len(x) - n + 1)
        ins.append((os.path.join(tmp, f"lane{i}.flac"), x[off:off + n]))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ins)) as pool:
        list(pool.map(lambda a: audio.write(a[0], a[1], SR,
                                            subtype="PCM_24"), ins))
    ins = [ip for ip, _ in ins]
    log(f"batch lanes: {len(ins)} FLACs of {seconds} s written in "
        f"{time.perf_counter() - t0:.3f} s (one thread each)")

    # the single-file runs, each with the ramp off as the batch has it
    refs, walls = [], []
    os.environ["TOMATIS_NO_RAMP"] = "1"
    try:
        for i, ip in enumerate(ins):
            ro = os.path.join(tmp, f"single{i}.flac")
            rc = os.path.join(tmp, f"single{i}.csv")
            st = standard.process(ip, ro, p, state_csv_path=rc,
                                  device="cuda")
            refs.append((ro, rc, st))
            walls.append(st["wall_seconds"])
    finally:
        del os.environ["TOMATIS_NO_RAMP"]

    launches = {}
    runs = {}
    for name, idx in (("batch_b8", list(range(8))), ("batch_b4", [0, 1, 2, 3]),
                      ("batch_corrupt", [0, 1, 2, 3])):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        lane_in = [ins[i] for i in idx]
        if name == "batch_corrupt":
            # lane 1 is a FLAC whose STREAMINFO is garbage
            bad = os.path.join(tmp, "corrupt.flac")
            with open(bad, "wb") as f:
                f.write(b"fLaC" + bytes(range(256)) * 64)
            lane_in[1] = bad
        jobs = [(ip, os.path.join(d, f"out{j}.flac"))
                for j, ip in enumerate(lane_in)]
        csvs = [os.path.join(d, f"st{j}.csv") for j in range(len(jobs))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(cuda_ola)
        t0 = time.perf_counter()
        stats = batch.process_batch(jobs, p, state_csv_paths=csvs,
                                    device="cuda")
        wall = time.perf_counter() - t0
        lt = dict(batch.LAST_TIMINGS)
        ok = [j for j in range(len(jobs))
              if not (name == "batch_corrupt" and j == 1)]
        want_chunks = -(-max(stats[j]["n_frames"] for j in ok) // 1024)
        if lt["chunks"] != want_chunks:
            fail(f"{name}: {lt['chunks']} batch chunks, expected "
                 f"{want_chunks}")
        launches[name] = read_batch_counts(cuda_ola, lt["chunks"], name)
        peak = torch.cuda.max_memory_allocated()
        for j, lane in enumerate(idx):
            if j not in ok:
                if stats[j]["failed"] is None:
                    fail(f"{name}: the corrupt lane did not fail")
                continue
            ro, rc, st = refs[lane]
            if stats[j]["failed"] is not None:
                fail(f"{name}: lane {j} failed: {stats[j]['failed']}")
            if not files_equal(jobs[j][1], ro) or not files_equal(csvs[j],
                                                                  rc):
                fail(f"{name}: lane {j}'s file or state CSV differs from "
                     f"its single-file run's")
        audio_s = sum(stats[j]["n_frames"] * p.hop / SR for j in ok)
        runs[name] = (wall, jobs, ok)
        log(f"{name}: {len(jobs)} lanes ({len(ok)} good), {lt['chunks']} "
            f"batch chunks, {launches[name]['chunk_tail_batched']} batched "
            f"launches and no single-file one; every good lane's FLAC and "
            f"state CSV equal its single-file run's byte for byte"
            + (f"; the corrupt lane failed alone: "
               f"{stats[1]['failed'][:60]!r}" if name == "batch_corrupt"
               else "")
            + f"; wall {wall:.3f} s, aggregate realtime factor "
            f"{audio_s / wall:.2f}x, LAST_TIMINGS {lt}, peak device memory "
            f"{peak / 1e9:.3f} GB")
    wall8, jobs8, _ = runs["batch_b8"]
    dec_s, enc_s = lanes_codecs_alone(audio, ins, [o for _, o in jobs8], tmp)
    log(f"batch against single files: B=8 wall {wall8:.3f} s, B=4 wall "
        f"{runs['batch_b4'][0]:.3f} s; the eight single-file walls "
        f"{[round(w, 3) for w in walls]} s, sum {sum(walls):.3f} s (first "
        f"four {sum(walls[:4]):.3f} s), longest {max(walls):.3f} s; alone, "
        f"one thread per lane side by side (the encoder's helpers "
        f"besides): decoding the eight inputs "
        f"{dec_s:.3f} s, encoding the eight outputs {enc_s:.3f} s; "
        f"{os.cpu_count()} host cores, encoder helper threads "
        f"{encoder_threads()}")
    return launches


def quiet_call(fn, *a):
    """fn(*a) with its standard output caught: (return value, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fn(*a)
    return r, buf.getvalue()


def only_chunk_tails(cuda_ola, what: str) -> dict:
    """The counts just after a path whose chunk count this script does not
    know: some chunk-tail launches, nothing else."""
    c = counts_of(cuda_ola)
    if c["chunk_tail"] == 0 or c["overlap_add"] or c["chunk_tail_batched"]:
        fail(f"{what}: launches {c} (expected chunk-tail launches only)")
    return tail_frames(cuda_ola, c)


def doctor_path(cuda_ola) -> dict:
    """Phase 19: `doctor` in this process on the card, exit 0."""
    from tomatis_tpu_torch.cli import doctor
    reset_counts(cuda_ola)
    t0 = time.perf_counter()
    rc, out = quiet_call(doctor.main, [])
    wall = time.perf_counter() - t0
    for ln in out.strip().splitlines():
        log(f"doctor: {ln}")
    if rc != 0:
        fail(f"doctor exited {rc}")
    c = only_chunk_tails(cuda_ola, "doctor")
    log(f"doctor: exit 0 in {wall:.3f} s, {c['chunk_tail']} chunk-tail "
        f"launches (its kernel check and its engine run)")
    return {"doctor": c}


def verifier_call(cli, fn, argv: list, dev: str):
    """fn, the library call behind a port verifier's CLI, with the
    arguments that argv gives through the CLI's parser and, where it has
    one, the params sidecar loader; on dev."""
    import inspect
    from tomatis_tpu_torch.cli._sidecar import apply_params
    args = cli.build_parser().parse_args(argv)
    if hasattr(args, "params"):
        apply_params(args, cli.build_parser, argv)
        del args.params
    kw = vars(args)
    kw["device"] = dev
    first, second = list(inspect.signature(fn).parameters)[:2]
    kw[first], kw[second] = kw.pop("input"), kw.pop("output")
    return fn(**kw)


def check_differences(a, b, tol: float, where: str = "") -> list:
    """Keys where two verifier results differ: bools, ints and strings
    unequal, floats (and lists of them) apart by more than tol."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{where}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a if k not in ("timings", "freqs")
                for d in check_differences(a[k], b[k], tol, f"{where}.{k}")]
    if isinstance(a, (bool, np.bool_, int, np.integer, str)):
        return [] if a == b else [f"{where}: {a} != {b}"]
    if np.max(np.abs(np.asarray(a, float) - np.asarray(b, float)),
              initial=0.0) > tol:
        return [f"{where}: {a} vs {b}"]
    return []


def spectra_differ(pa: str, pb: str, tol: float) -> float:
    """Largest per-bin difference of two spectrum CSVs over 20 Hz-20 kHz."""
    a = np.loadtxt(pa, delimiter=",", skiprows=1)
    b = np.loadtxt(pb, delimiter=",", skiprows=1)
    band = (a[:, 0] >= 20) & (a[:, 0] <= 20000)
    d = float(np.max(np.abs(a[band] - b[band])))
    if not np.array_equal(a[:, 0], b[:, 0]) or d > tol:
        fail(f"spectrum CSVs {os.path.basename(pa)} and "
             f"{os.path.basename(pb)} differ by {d} dB (> {tol})")
    return d


def verifier_paths(torch, cuda_ola, standard, ip, lip, lop, lcp,
                   tmp) -> dict:
    """Phase 20. ip: the 60 s WAV; lip, lop, lcp: the 10-minute FLAC, its
    pcm24 output and state CSV (phase 15)."""
    from tomatis_tpu_torch.cli import main as cli_main
    from tomatis_tpu_torch.cli import validate as cli_validate
    from tomatis_tpu_torch.cli import verify_15db as cli_v15
    from tomatis_tpu_torch.cli import verify_15db_v2 as cli_v2
    from tomatis_tpu_torch.cli import verify_tilt as cli_tilt
    from tomatis_tpu_torch.cli._sidecar import write_sidecar
    from tomatis_tpu_torch.cli.process import sidecar_fields
    from tomatis_tpu_torch.verify import tilt_amplitude, validate_layer1
    from tomatis_tpu_torch.verify import verify_15db, verify_15db_v2
    d = os.path.join(tmp, "verify")
    os.makedirs(d)
    sop, scp = os.path.join(d, "std.wav"), os.path.join(d, "std.csv")
    aop = os.path.join(d, "adapt.wav")
    launches = {}
    p = standard.StandardParams()
    chunks60 = len(chunk_schedule(standard, p, 60 * SR))
    reset_counts(cuda_ola)
    rc, _ = quiet_call(cli_main.main, ["process", "-i", ip, "-o", sop,
                                       "--state_csv", scp, "--device",
                                       "cuda"])
    launches["verify_process"] = read_counts(cuda_ola, chunks60,
                                             "verifiers' process run")
    reset_counts(cuda_ola)
    rc_a, _ = quiet_call(cli_main.main, ["process-adaptive", "-i", ip, "-o",
                                         aop, "--device", "cuda"])
    launches["verify_adaptive"] = only_chunk_tails(
        cuda_ola, "verifiers' process-adaptive run")
    if rc or rc_a or not os.path.exists(sop + ".params.json") \
            or not os.path.exists(aop + ".params.json"):
        fail(f"process / process-adaptive for the verifiers: exit {rc} / "
             f"{rc_a}, or no params sidecar")

    cases = [
        ("validate", cli_validate, validate_layer1.validate, 1e-3,
         lambda tag: ["-i", ip, "-o", sop, "--state_csv", scp, "--out_csv",
                      os.path.join(d, f"l1_{tag}.csv"), "--out_png", ""]),
        ("verify-15db", cli_v15, verify_15db.verify, 1e-3,
         lambda tag: ["-i", ip, "-o", sop, "--out_prefix",
                      os.path.join(d, f"v15_{tag}")]),
        ("verify-15db-v2", cli_v2, verify_15db_v2.verify_v2, 1e-3,
         lambda tag: ["-i", ip, "-o", aop, "--out_prefix",
                      os.path.join(d, f"v2_{tag}")]),
        ("verify-tilt", cli_tilt, tilt_amplitude.analyze_tilt_amplitude,
         1e-3, lambda tag: ["-i", ip, "-o", sop]),
    ]
    spectrum_of = {"validate": "l1_{}.csv",
                   "verify-15db": "v15_{}_spectrum.csv",
                   "verify-15db-v2": "v2_{}_spectrum.csv"}
    for name, cli, fn, tol, argv in cases:
        t0 = time.perf_counter()
        rc, out = quiet_call(cli.main, argv("cli") + ["--device", "cuda"])
        wall_cli = time.perf_counter() - t0
        if name != "verify-tilt" and "params loaded from" not in out:
            fail(f"{name}: the sidecar was not loaded")
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = (verifier_call(cli, fn, argv(dev), dev),
                        time.perf_counter() - t0)
        card, cpu = res["cuda"][0], res["cpu"][0]
        if name == "verify-tilt":
            card = {k: v for k, v in card.items()
                    if k not in ("c1_avg", "c2_avg")}
            cpu = {k: v for k, v in cpu.items()
                   if k not in ("c1_avg", "c2_avg")}
            verdict = "c1_tilt" in card
            ok_rc = rc == 0
        else:
            verdict = card["pass"]
            ok_rc = (rc == 0) == verdict
            if name == "verify-15db-v2":
                # the bisection's last steps may part on levels 1e-6 dB
                # apart (tests/test_torch_verify.py)
                if abs(card.pop("auto_threshold_dbfs")
                       - cpu.pop("auto_threshold_dbfs")) > 1e-4:
                    fail("verify-15db-v2: card and CPU thresholds differ")
        diffs = check_differences(card, cpu, tol)
        if diffs or not ok_rc:
            fail(f"{name}: CLI exit {rc}, card vs CPU differences {diffs}")
        extra = ""
        if name in spectrum_of:
            dmax = spectra_differ(
                os.path.join(d, spectrum_of[name].format("cuda")),
                os.path.join(d, spectrum_of[name].format("cpu")), 1e-2)
            extra = f", spectrum CSVs within {dmax:.2e} dB per bin"
        how = "" if name == "verify-tilt" else ", sidecar only"
        log(f"{name} (60 s{how}): CLI on the card exit {rc} in "
            f"{wall_cli:.3f} s; library call card {res['cuda'][1]:.3f} s, "
            f"CPU {res['cpu'][1]:.3f} s: verdict "
            f"{'PASS' if verdict else 'FAIL'} on both, every count and "
            f"flag equal, metrics within {tol}{extra}")

    # full size: the 10-minute FLAC -> FLAC pcm24 output of phase 15
    write_sidecar(lop, "process", sidecar_fields(p))
    for name, cli, fn, argv in (
            ("validate", cli_validate, validate_layer1.validate,
             ["-i", lip, "-o", lop, "--state_csv", lcp, "--out_csv",
              os.path.join(d, "long_l1.csv"), "--out_png", ""]),
            ("verify-15db", cli_v15, verify_15db.verify,
             ["-i", lip, "-o", lop, "--out_prefix",
              os.path.join(d, "long_v15")])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = verifier_call(cli, fn, argv, "cuda")
        wall = time.perf_counter() - t0
        sp = r["checks"]["spectrum"]
        log(f"{name} full size (10-minute FLAC to FLAC pcm24 output, state "
            f"CSV, sidecar): verdict {'PASS' if r['pass'] else 'FAIL'}, "
            f"stable frames C1 {sp['c1_frames']} / C2 {sp['c2_frames']}, "
            f"wall {wall:.3f} s, split "
            f"{ {k: round(v, 3) for k, v in r['timings'].items()} }, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
            f"GB, of which {held / 1e9:.3f} GB earlier phases still held")
    return launches


def case_study_path(cuda_ola, tmp) -> dict:
    """Phase 21: the calibration case study, 40 s, on the card."""
    from tomatis_tpu_torch.verify.case_study import TRUE, run_case_study
    reset_counts(cuda_ola)
    t0 = time.perf_counter()
    r, _ = quiet_call(run_case_study, os.path.join(tmp, "case"), 40.0, 7,
                      "cuda")
    wall = time.perf_counter() - t0
    c = only_chunk_tails(cuda_ola, "case study")
    err = r["errors"]
    gain_err = abs(r["compare"]["anchor_gain_db"] - TRUE["gain_db"])
    if not (err["threshold_db"] < 0.6 and err["hyst_db"] < 0.01
            and err["gain_db"] < 1.0 and err["delay_s"] < 0.03
            and r["validate_pass"] and gain_err < 0.5):
        fail(f"case study outside tests/test_case_study.py's tolerances: "
             f"errors {err}, validate_pass {r['validate_pass']}, anchor "
             f"gain {r['compare']['anchor_gain_db']}")
    log(f"case study (40 s, calibrate-v2 -> process --calibration -> "
        f"validate -> compare on the card): errors {err}, validate PASS, "
        f"anchor gain {r['compare']['anchor_gain_db']:.3f} dB (truth "
        f"{TRUE['gain_db']}), {c['chunk_tail']} chunk-tail launches, wall "
        f"{wall:.3f} s")
    return {"case_study": c}


def analyzer_paths(ip, op, cp, tmp):
    """Phase 22: the ten analyzer commands on the 60 s files. Only
    analyze-stereo runs torch ops: it runs on the card and on the CPU and
    its CSVs must be equal; the host-only commands run twice and must
    print and write the same."""
    from tomatis_tpu_torch.cli import main as cli_main
    d = os.path.join(tmp, "analyzers")

    def both(cmd, argv_of, files=()):
        runs = []
        for tag in ("cuda", "cpu"):
            od = os.path.join(d, tag)
            os.makedirs(od, exist_ok=True)
            t0 = time.perf_counter()
            rc, text = quiet_call(cli_main.main, [cmd] + argv_of(od, tag))
            runs.append((rc, text.replace(od, "<dir>"),
                         [open(os.path.join(od, f), "rb").read()
                          for f in files], time.perf_counter() - t0))
        (rc_a, out_a, f_a, t_a), (rc_b, out_b, f_b, t_b) = runs
        if rc_a or rc_b or out_a != out_b or f_a != f_b:
            fail(f"{cmd}: exits {rc_a}/{rc_b}, console or files differ "
                 f"between its two runs:\n{out_a[-800:]}\n{out_b[-800:]}")
        first = out_a.strip().splitlines()[0] if out_a.strip() else ""
        log(f"{cmd}: exit 0 twice ({t_a:.3f} s, {t_b:.3f} s), the same "
            f"console and {len(files)} file(s) byte for byte; {first[:100]}")

    both("analyze-stereo", lambda od, t: ["-i", ip, "-o",
                                          os.path.join(od, "st.csv"),
                                          "--device", t], ["st.csv"])
    both("analyze-dbfs", lambda od, t: ["-i", ip])
    both("compare-dbfs", lambda od, t: ["-i", ip, "-c", op, "--out_prefix",
                                        os.path.join(od, "dbfs")],
         ["dbfs_out.csv"])
    both("analyze-gate-threshold",
         lambda od, t: [os.path.join(d, "cuda", "dbfs_out.csv")])
    both("merge-state-volume", lambda od, t: ["--state_csv", cp, "--audio",
                                              op, "-o", os.path.join(
                                                  od, "merged.csv")],
         ["merged.csv"])
    both("inspect", lambda od, t: ["-i", ip, "--print_sec", "5"])
    both("inspect-transition", lambda od, t: ["-i", ip])
    both("find-segment", lambda od, t: ["-i", ip, "--min_seg_sec", "10"])
    both("find-start", lambda od, t: ["-i", ip])
    both("find-end", lambda od, t: ["-i", ip])


def read_sharded_counts(cuda_ola, super_chunks: int, n_seq: int,
                        what: str) -> dict:
    """The launch counts just after a sharded path: two standalone
    overlap-add launches per shard and super-chunk (the frames' and the
    window weights'), nothing else."""
    c = counts_of(cuda_ola)
    want = 2 * n_seq * super_chunks
    if want == 0 or c != {"chunk_tail": 0, "overlap_add": want,
                          "chunk_tail_batched": 0}:
        fail(f"{what}: launches {c}, expected {want} overlap-add launches "
             f"(2 x {n_seq} shards x {super_chunks} super-chunks) only")
    return c


def lsb_apart(audio, a: str, b: str, what: str) -> float:
    """Fails unless two PCM_24 files are within 1 LSB on under 1% of
    their samples; returns that share."""
    pa, pb = pcm_of(audio, a), pcm_of(audio, b)
    if pa.shape != pb.shape:
        fail(f"{what}: shapes {pa.shape} and {pb.shape}")
    d = np.abs(pa - pb)
    share = float((d > 0).mean())
    if d.max() > 1 or share >= 0.01:
        fail(f"{what}: max {d.max()} LSB apart on {100 * share:.3f}% of "
             f"the samples (1 LSB on under 1% allowed)")
    return share


def csv_rows_agree(a: str, b: str, what: str) -> bool:
    """The crossfade state CSVs of two runs: frame, time, level and state
    equal, alpha (printed %.3f) within 0.001. Returns whether the files
    are byte-equal as well."""
    ra, rb = open(a).read().splitlines(), open(b).read().splitlines()
    if len(ra) != len(rb) or ra[0] != rb[0]:
        fail(f"{what}: {len(ra)} and {len(rb)} rows")
    for x, y in zip(ra[1:], rb[1:]):
        cx, cy = x.split(","), y.split(",")
        if cx[:4] != cy[:4] or abs(float(cx[4]) - float(cy[4])) > 0.001:
            fail(f"{what}: rows {x!r} and {y!r} differ")
    return ra == rb


def sharded_paths(torch, cuda_ola, audio, standard, x, ip, op, cp,
                  tmp) -> dict:
    """Phases 23-25: process-sharded on the card. x: the long programme;
    ip, op, cp: the 60 s WAV, its `process` output and state CSV (phase
    5)."""
    from tomatis_tpu_torch.cli import main as cli_main
    from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
    from tomatis_tpu_torch.models import adaptive, xfade
    from tomatis_tpu_torch.parallel.stream import (process_sharded,
                                                   process_sharded_adaptive)
    d = os.path.join(tmp, "sharded")
    os.makedirs(d)
    card4 = [torch.device("cuda", 0)] * 4
    fps = 256
    p = standard.StandardParams()
    launches = {}

    # -- 23. full size: the 10-minute programme, WAV to WAV
    lip = os.path.join(d, "long.wav")
    t0 = time.perf_counter()
    audio.write(lip, x, SR, subtype="PCM_24")
    log(f"sharded: the {len(x) / SR:.0f} s programme written as a 48 kHz "
        f"stereo PCM_24 WAV in {time.perf_counter() - t0:.3f} s")
    sop, scp = os.path.join(d, "single.wav"), os.path.join(d, "single.csv")
    hop_, hcp = os.path.join(d, "shard.wav"), os.path.join(d, "shard.csv")
    sst = standard.process(lip, sop, p, state_csv_path=scp, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts(cuda_ola)
    hst = process_sharded(lip, hop_, p, frames_per_shard=fps,
                          state_csv_path=hcp, devices=card4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_super = -(-hst["n_frames"] // (fps * 4))
    launches["sharded_standard"] = read_sharded_counts(
        cuda_ola, n_super, 4, "process-sharded, 10 minutes")
    if hst["mesh"] != {"data": 1, "seq": 4}:
        fail(f"process-sharded mesh {hst['mesh']}")
    if not files_equal(hop_, sop) or not files_equal(hcp, scp):
        fail("process-sharded on 4 shards: the WAV or the state CSV "
             "differs from the single-device process run's bytes")
    log(f"process-sharded full size ({len(x) / SR / 60:.0f}-minute WAV to "
        f"WAV, StandardParams, "
        f"frames_per_shard {fps}, devices=[cuda:0]*4, mesh {hst['mesh']}): "
        f"output WAV and state CSV equal the single-device process run's "
        f"byte for byte; {hst['n_frames']} frames in {n_super} super-chunks, "
        f"{launches['sharded_standard']['overlap_add']} overlap-add launches "
        f"(2 x 4 shards x {n_super}), no chunk-tail launch; wall "
        f"{hst['wall_seconds']:.3f} s, realtime factor "
        f"{hst['realtime_factor']:.2f}x, split {hst['timings']} (read: the "
        f"input window; step: upload, framing, the sharded step and the "
        f"emit's readback; write: CSV rows, flush cuts, WAV writes); the "
        f"single-device process run: wall {sst['wall_seconds']:.3f} s, "
        f"realtime factor {sst['realtime_factor']:.2f}x; peak device "
        f"memory {peak / 1e9:.3f} GB, of which {held / 1e9:.3f} GB held "
        f"before the run")

    # -- 24. the crossfade and adaptive variants and the CLI, 60 s WAV
    px = xfade.XfadeParams(gate_ui=60.0, xfade_ms=200.0)
    xop, xcp = os.path.join(d, "xf.wav"), os.path.join(d, "xf.csv")
    hxop, hxcp = os.path.join(d, "xf_sh.wav"), os.path.join(d, "xf_sh.csv")
    xfade.process(ip, xop, px, state_csv_path=xcp, device="cuda")
    reset_counts(cuda_ola)
    hx = process_sharded(ip, hxop, px, frames_per_shard=fps,
                         state_csv_path=hxcp, variant="xfade",
                         devices=card4)
    launches["sharded_xfade"] = read_sharded_counts(
        cuda_ola, -(-hx["n_frames"] // (fps * 4)), 4,
        "process-sharded xfade, 60 s")
    share = lsb_apart(audio, hxop, xop, "process-sharded xfade")
    same_csv = csv_rows_agree(hxcp, xcp, "process-sharded xfade state CSV")
    log(f"process-sharded xfade (60 s, gate_ui 60, xfade_ms 200, 4 shards):"
        f" within 1 LSB of xfade.process on {100 * share:.4f}% of the "
        f"samples (equal elsewhere); state CSV rows agree (byte-equal: "
        f"{same_csv}); {launches['sharded_xfade']['overlap_add']} "
        f"overlap-add launches; wall {hx['wall_seconds']:.3f} s")

    pa = adaptive.AdaptiveParams()
    aop, acp = os.path.join(d, "ad.wav"), os.path.join(d, "ad.csv")
    haop, hacp = os.path.join(d, "ad_sh.wav"), os.path.join(d, "ad_sh.csv")
    ai = adaptive.process(ip, aop, pa, state_csv_path=acp, device="cuda")
    reset_counts(cuda_ola)
    ha = process_sharded_adaptive(ip, haop, pa, frames_per_shard=fps,
                                  state_csv_path=hacp, devices=card4)
    launches["sharded_adaptive"] = read_sharded_counts(
        cuda_ola, -(-ha["n_frames"] // (fps * 4)), 4,
        "process-sharded adaptive, 60 s")
    for k in ("optimal_threshold", "atten_db", "switch_count"):
        if ha[k] != ai[k]:
            fail(f"process-sharded adaptive {k}: {ha[k]} != {ai[k]}")
    share = lsb_apart(audio, haop, aop, "process-sharded adaptive")
    if not files_equal(hacp, acp):
        fail("process-sharded adaptive: the state CSV differs")
    log(f"process-sharded adaptive (60 s, 4 shards): threshold "
        f"{ha['optimal_threshold']:.4f} dBFS, atten {ha['atten_db']:.3f} dB,"
        f" {ha['switch_count']} switches, all equal to adaptive.process; "
        f"within 1 LSB on {100 * share:.4f}% of the samples; state CSV "
        f"equal; {launches['sharded_adaptive']['overlap_add']} overlap-add "
        f"launches; wall {ha['wall_seconds']:.3f} s")

    cop, ccp = os.path.join(d, "cli.wav"), os.path.join(d, "cli.csv")
    n_dev = torch.cuda.device_count()
    reset_counts(cuda_ola)
    rc, out = quiet_call(cli_main.main, ["process-sharded", "-i", ip, "-o",
                                         cop, "--state_csv", ccp])
    if rc != 0 or f"mesh: data=1 seq={n_dev}" not in out:
        fail(f"process-sharded CLI: exit {rc}\n{out[-800:]}")
    n_frames = int(re.search(r"frames: (\d+)", out).group(1))
    launches["sharded_cli"] = read_sharded_counts(
        cuda_ola, -(-n_frames // (fps * n_dev)), n_dev,
        "process-sharded CLI, 60 s")
    if not files_equal(cop, op) or not files_equal(ccp, cp):
        fail("process-sharded CLI: output or state CSV differs from "
             "process's (phase 5)")
    log(f"process-sharded CLI (60 s, no --devices: {n_dev} shard(s) on "
        f"this machine's {n_dev} card(s)): exit 0, output and state CSV "
        f"equal process's byte for byte, "
        f"{launches['sharded_cli']['overlap_add']} overlap-add launches")

    # -- 25. resume: stopped by the sink after two snapshots, then rerun
    class SinkStopped(Exception):
        pass

    ck = os.path.join(d, "ck.npz")
    rop, rcp = os.path.join(d, "res.wav"), os.path.join(d, "res.csv")
    kw = dict(frames_per_shard=64, state_csv_path=rcp, checkpoint_path=ck,
              checkpoint_every=1)
    saves = [0]
    save, write = CheckpointManager.maybe_save, standard._RawWav.write

    def counting_save(self, state, force=False):
        r = save(self, state, force)
        saves[0] += int(bool(r))
        return r

    def stop_after_two(self, data):
        if saves[0] >= 2:
            raise SinkStopped()
        return write(self, data)

    CheckpointManager.maybe_save = counting_save
    standard._RawWav.write = stop_after_two
    try:
        process_sharded(ip, rop, p, devices=card4, **kw)
    except SinkStopped:
        pass
    else:
        fail("sharded resume: the sink's exception did not stop the run")
    finally:
        CheckpointManager.maybe_save = save
        standard._RawWav.write = write
    if not os.path.exists(ck):
        fail("sharded resume: no checkpoint after the stop")
    try:
        process_sharded(ip, rop, p, devices=card4[:2], **kw)
    except ValueError as e:
        refused = str(e)
    else:
        fail("sharded resume: a rerun on a 2-shard mesh was not refused")
    reset_counts(cuda_ola)
    rst = process_sharded(ip, rop, p, devices=card4, **kw)
    total_super = -(-rst["n_frames"] // (64 * 4))
    launches["sharded_resume"] = read_sharded_counts(
        cuda_ola, total_super - 2, 4, "sharded resume")
    if os.path.exists(ck) or not files_equal(rop, op) \
            or not files_equal(rcp, cp):
        fail("sharded resume: the checkpoint was left behind, or the "
             "output or state CSV differs from the uninterrupted bytes")
    log(f"sharded resume (60 s, 64 frames per shard x 4): stopped by the "
        f"sink after 2 of {total_super} super-chunks, a rerun on 2 shards "
        f"refused ({refused[:60]!r}), resumed with {total_super - 2} left "
        f"({launches['sharded_resume']['overlap_add']} overlap-add "
        f"launches): output and state CSV equal the uninterrupted bytes")
    return launches


@contextlib.contextmanager
def batch_link(batch, wire: bool):
    """process_batch's transport rule as it stands (False: this card's link
    rate against WIRE_BATCH_LINK_MBPS, which keeps pcm24), or with the
    threshold raised past any link (True: the rule picks wire, as on a
    host whose link is slower than the threshold)."""
    keep = batch.WIRE_BATCH_LINK_MBPS
    if wire:
        batch.WIRE_BATCH_LINK_MBPS = float("inf")
    try:
        yield
    finally:
        batch.WIRE_BATCH_LINK_MBPS = keep


def wire_batch_run(torch, cuda_ola, batch, p, jobs, csvs, tr: str,
                   what: str):
    """One process_batch call on the card with the launch counts set to 0
    just before it and read just after (one batched launch per batch
    chunk, nothing else); tr is the transport the rule must pick. Returns
    (stats, wall, LAST_TIMINGS, LAST_WIRE, counts, peak device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ola)
    with batch_link(batch, tr == "wire"):
        t0 = time.perf_counter()
        stats = batch.process_batch(jobs, p, state_csv_paths=csvs,
                                    device="cuda")
        wall = time.perf_counter() - t0
    lt, lw = dict(batch.LAST_TIMINGS), dict(batch.LAST_WIRE)
    counts = read_batch_counts(cuda_ola, lt["chunks"], what)
    if lt["transport"] != tr or bool(lw) != (tr == "wire"):
        fail(f"{what}: transport {lt['transport']}, LAST_WIRE {lw}")
    bad = [(j, s["failed"]) for j, s in enumerate(stats)
           if s["failed"] is not None]
    if bad:
        fail(f"{what}: lanes failed: {bad}")
    return (stats, wall, lt, lw, counts,
            torch.cuda.max_memory_allocated())


def pcm24_link_bytes(p, chunks: int, lanes: int, ch: int = 2,
                     F: int = 1024) -> int:
    """The bytes the pcm24 batch moves over the link: each batch chunk's
    float32 [B, L, C] windows up and its PCM_24 [B, F*hop, C] emit down
    (aux rows, which wire ships too, left out)."""
    L = (F - 1) * p.hop + p.n_fft
    return chunks * lanes * (L * ch * 4 + F * p.hop * ch * 3)


def wire_batch_path(torch, cuda_ola, audio, standard, x, tmp) -> dict:
    """Phase 28: process_batch on wire (the threshold raised past this
    card's link) against the pcm24 batch of the same call, byte for byte:
    (a) phase 18's eight FLAC lanes at B = 8, in turns with pcm24, twice
    each, and the link rate at which wire's saved bytes would pay for its
    extra wall; (b) the 10-minute FLAC of phase 15 beside the 60 s one,
    in turns with pcm24; (c) a FLOAT WAV lane that is not PCM_24-exact
    beside a PCM_24 one (the raw-float fallback)."""
    from tomatis_tpu_torch.io import wirecodec
    from tomatis_tpu_torch.ops import wire as wire_ops
    from tomatis_tpu_torch.parallel import batch
    p = standard.StandardParams()
    if not wirecodec.available():
        fail("wire batch: the native wire codec (csrc/wire.cpp) is not "
             "loaded")
    link = batch._link_mbps(torch.device("cuda"))
    if batch.batch_transport([torch.device("cuda")], False) != "pcm24":
        fail(f"wire batch: the rule picks wire on this card's link "
             f"({link:.0f} MB/s against {batch.WIRE_BATCH_LINK_MBPS} MB/s)")
    log(f"wire batch: this card's read-back link {link:.0f} MB/s against "
        f"the wire threshold {batch.WIRE_BATCH_LINK_MBPS:.0f} MB/s: the "
        f"rule keeps pcm24; the wire runs below raise the threshold")
    # the numpy codec must not run: count any call into it
    numpy_calls = [0]
    np_enc, np_dec = wire_ops.encode_np, wire_ops.decode_np

    def counted(fn):
        def call(*a, **k):
            numpy_calls[0] += 1
            return fn(*a, **k)
        return call

    wire_ops.encode_np, wire_ops.decode_np = counted(np_enc), counted(np_dec)
    launches = {}

    def compare(name, jobs_w, csvs_w, jobs_p, csvs_p):
        for j, ((_, ow), (_, op)) in enumerate(zip(jobs_w, jobs_p)):
            if not files_equal(ow, op) or (
                    csvs_w and not files_equal(csvs_w[j], csvs_p[j])):
                fail(f"{name}: lane {j}'s file or state CSV differs from "
                     f"the pcm24 batch's")

    def ratios(lw):
        return (f"in shipped/used {lw['in_shipped'] / lw['in_used']:.7f} "
                f"({lw['in_used']} B used), out shipped/used "
                f"{lw['out_shipped'] / lw['out_used']:.7f} "
                f"({lw['out_used']} B used)")

    try:
        # (a) eight lanes, B = 8
        ins = [os.path.join(tmp, f"lane{i}.flac") for i in range(8)]
        outs, walls, shipped = {}, {"pcm24": [], "wire": []}, {}
        for k, tr in enumerate(("pcm24", "wire", "wire", "pcm24")):
            d = os.path.join(tmp, f"wire_b8_{k}")
            os.makedirs(d)
            jobs = [(ip, os.path.join(d, f"out{j}.flac"))
                    for j, ip in enumerate(ins)]
            csvs = [os.path.join(d, f"st{j}.csv") for j in range(8)]
            stats, wall, lt, lw, c, peak = wire_batch_run(
                torch, cuda_ola, batch, p, jobs, csvs, tr,
                f"wire batch (a) run {k + 1} ({tr})")
            if tr == "wire":
                launches.setdefault("batch_wire_b8", c)
                shipped["wire"] = lw["in_shipped"] + lw["out_shipped"]
            else:
                shipped["pcm24"] = pcm24_link_bytes(p, lt["chunks"], 8)
            walls[tr].append(wall)
            outs.setdefault(tr, (jobs, csvs))
            compare(f"wire batch (a) run {k + 1}", jobs, csvs,
                    *outs["pcm24"])
            audio_s = sum(s["n_frames"] * p.hop / SR for s in stats)
            log(f"wire batch (a) run {k + 1}, {tr}: 8 lanes, "
                f"{lt['chunks']} batch chunks, {c['chunk_tail_batched']} "
                f"batched launches and no single-file one; every lane's "
                f"FLAC and state CSV equal the pcm24 run's; wall {wall:.3f}"
                f" s, aggregate realtime factor {audio_s / wall:.2f}x, peak "
                f"device memory {peak / 1e9:.3f} GB"
                + (f", {ratios(lw)}" if lw else "") + f"; LAST_TIMINGS {lt}"
                + (f"; LAST_WIRE {lw}" if lw else ""))
        saved = shipped["pcm24"] - shipped["wire"]
        extra = statistics.mean(walls["wire"]) - statistics.mean(
            walls["pcm24"])
        log(f"wire batch (a): link bytes a run pcm24 {shipped['pcm24']}, "
            f"wire {shipped['wire']} ({saved} B saved); wire's wall "
            f"{extra:+.3f} s against pcm24's by the means; "
            + (f"wire pays below a link of {saved / 1e6 / extra:.0f} MB/s "
               f"(threshold {batch.WIRE_BATCH_LINK_MBPS:.0f})"
               if extra > 0 else "wire was not slower in this call"))

        # (b) the 10-minute FLAC beside a 60 s lane: 14 batch chunks, the
        # lanes' encodes and decodes in this process all the same
        ins = [os.path.join(tmp, "long.flac"), os.path.join(tmp, "in.flac")]
        outs, walls = {}, {"pcm24": [], "wire": []}
        for k, tr in enumerate(("wire", "pcm24", "pcm24", "wire")):
            d = os.path.join(tmp, f"wire_long_{k}")
            os.makedirs(d)
            jobs = [(ip, os.path.join(d, f"out{j}.flac"))
                    for j, ip in enumerate(ins)]
            csvs = [os.path.join(d, f"st{j}.csv") for j in range(2)]
            stats, wall, lt, lw, c, peak = wire_batch_run(
                torch, cuda_ola, batch, p, jobs, csvs, tr,
                f"wire batch (b) run {k + 1} ({tr})")
            outs.setdefault(tr, (jobs, csvs))
            if tr == "wire":
                launches.setdefault("batch_wire_long", c)
            walls[tr].append(wall)
            audio_s = sum(s["n_frames"] * p.hop / SR for s in stats)
            log(f"wire batch (b) run {k + 1}, {tr}: the 10-minute FLAC and "
                f"a 60 s lane, {lt['chunks']} batch chunks, "
                f"{c['chunk_tail_batched']} batched launches; wall "
                f"{wall:.3f} s, aggregate realtime factor "
                f"{audio_s / wall:.2f}x, peak device memory "
                f"{peak / 1e9:.3f} GB"
                + (f", {ratios(lw)}" if lw else "") + f"; LAST_TIMINGS {lt}")
        compare("wire batch (b)", *outs["wire"], *outs["pcm24"])
        d_wire = (statistics.mean(walls["wire"])
                  - statistics.mean(walls["pcm24"]))
        log(f"wire batch (b): both lanes' FLACs and state CSVs equal the "
            f"pcm24 run's byte for byte; walls wire "
            f"{[round(w, 3) for w in walls['wire']]} s, pcm24 "
            f"{[round(w, 3) for w in walls['pcm24']]} s, wire "
            f"{d_wire:+.3f} s against pcm24 by the means")

        # (c) a FLOAT WAV that is not PCM_24-exact (20 s) beside the 60 s
        # PCM_24 FLAC: its chunks ship raw floats, the last one the codec
        fw = os.path.join(tmp, "float_lane.wav")
        audio.write(fw, x[:20 * SR] + np.float32(1e-9), SR, subtype="FLOAT")
        ins = [fw, os.path.join(tmp, "in.flac")]
        outs = {}
        for tr in ("wire", "pcm24"):
            d = os.path.join(tmp, f"wire_float_{tr}")
            os.makedirs(d)
            jobs = [(ip, os.path.join(d, f"out{j}.flac"))
                    for j, ip in enumerate(ins)]
            stats, wall, lt, lw, c, peak = wire_batch_run(
                torch, cuda_ola, batch, p, jobs, None, tr,
                f"wire batch (c) {tr}")
            outs[tr] = (jobs, None)
            if tr == "wire":
                launches["batch_wire_float"] = c
                if not 0 < lw["in_raw_chunks"] < lt["chunks"]:
                    fail(f"wire batch (c): {lw['in_raw_chunks']} of "
                         f"{lt['chunks']} chunks shipped raw floats "
                         f"(expected the float lane's only)")
                log(f"wire batch (c): {lt['chunks']} batch chunks, "
                    f"{lw['in_raw_chunks']} of them raw floats (the float "
                    f"lane's), the rest through the codec; wall {wall:.3f} "
                    f"s; LAST_WIRE {lw}")
        compare("wire batch (c)", *outs["wire"], *outs["pcm24"])
        log("wire batch (c): both lanes equal the pcm24 run's bytes")
    finally:
        wire_ops.encode_np, wire_ops.decode_np = np_enc, np_dec
    if numpy_calls[0]:
        fail(f"wire batch: the numpy wire codec ran {numpy_calls[0]} times "
             f"(the native one must encode and decode)")
    log("wire batch: every encode and decode in this process ran in the "
        "native codec (no call into the numpy one)")
    return launches


def batch_devices_path(torch, cuda_ola, standard, tmp) -> dict:
    """Phase 26: three FLAC lanes of phase 18 on devices=[cuda:0]*2 (two
    lane blocks, padded to 4 lanes), each lane against its devices=None
    run of phase 18 (B = 4)."""
    from tomatis_tpu_torch.parallel import batch
    p = standard.StandardParams()
    d = os.path.join(tmp, "batch_devices")
    os.makedirs(d)
    ref = os.path.join(tmp, "batch_b4")
    jobs = [(os.path.join(tmp, f"lane{j}.flac"),
             os.path.join(d, f"out{j}.flac")) for j in range(3)]
    csvs = [os.path.join(d, f"st{j}.csv") for j in range(3)]
    reset_counts(cuda_ola)
    t0 = time.perf_counter()
    stats = batch.process_batch(jobs, p, state_csv_paths=csvs,
                                devices=[torch.device("cuda", 0)] * 2)
    wall = time.perf_counter() - t0
    lt = dict(batch.LAST_TIMINGS)
    c = counts_of(cuda_ola)
    by = dict(cuda_ola.chunk_tail_batched_cuda.by_variant)
    want = 2 * lt["chunks"]
    if c != {"chunk_tail": 0, "overlap_add": 0, "chunk_tail_batched": want} \
            or by != {("eps", "pcm24", 2): want} \
            or lt["block_launches"] != [lt["chunks"]] * 2:
        fail(f"process-batch --devices: launches {c}, variants {by}, "
             f"block launches {lt['block_launches']} over {lt['chunks']} "
             f"batch chunks (expected one batched launch per block and "
             f"chunk)")
    for j in range(3):
        if stats[j]["failed"] is not None or not files_equal(
                jobs[j][1], os.path.join(ref, f"out{j}.flac")) \
                or not files_equal(csvs[j], os.path.join(ref, f"st{j}.csv")):
            fail(f"process-batch --devices: lane {j} differs from its "
                 f"devices=None run ({stats[j]['failed']})")
    log(f"process-batch devices=[cuda:0]*2: 3 lanes padded to 4 (one idle),"
        f" {lt['chunks']} batch chunks, launches per lane block "
        f"{lt['block_launches']} ({c['chunk_tail_batched']} batched "
        f"launches in all, no other kernel); every lane's FLAC and state "
        f"CSV equal its devices=None run's byte for byte; wall {wall:.3f} "
        f"s, LAST_TIMINGS {lt}")
    return {"batch_devices": c}


def reverse_pair(audio, standard, d: str) -> tuple:
    """A 60 s input and its rendition by the standard processor on the
    card, for reverse-engineer: tests/test_reverse.py's signal (AR(1)
    noise, its level swept across a -32 dBFS linear gate, hysteresis 1
    dB, no up-delay). The programme's tones, rectified by the power-mono
    envelope that reverse-engineer analyses, blur its loud frames' tilt
    below the +5 dB that marks C2, so it gives no threshold estimate."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(21)
    n = 60 * SR
    t = np.arange(n) / SR
    noise = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    env = 0.05 * 10 ** (1.2 * np.sin(2 * np.pi * 0.21 * t) / 2)
    x = np.clip(np.stack([env * noise, 0.95 * env * noise], 1), -1,
                1).astype(np.float32)
    p = standard.StandardParams(gate_mode="linear", gate_ui=50.0,
                                gate_offset=-82.0, hysteresis_db=1.0,
                                up_delay_ms=0.0)
    y, _ = standard.process_array(x, SR, p, device="cuda",
                                  transport="pcm24")
    rip, rop = os.path.join(d, "rev_in.wav"), os.path.join(d, "rev_out.wav")
    audio.write(rip, x, SR, subtype="PCM_24")
    audio.write(rop, y, SR, subtype="PCM_24")
    return rip, rop


def comparison_paths(audio, standard, ip, op, tmp):
    """Phase 27: compare-baseline, compare-three, compare-diff-spectrum and
    plot-diff on the 60 s input and its `process` output, reverse-engineer
    on reverse_pair's: the five commands on the card, then the library
    calls on the card and on the CPU."""
    from tomatis_tpu_torch.analysis import compare_suite as cs
    from tomatis_tpu_torch.analysis.reverse import analyze_device_params
    from tomatis_tpu_torch.cli import main as cli_main
    d = os.path.join(tmp, "compare")
    cli = os.path.join(d, "cli")
    os.makedirs(cli)
    rip, rop = reverse_pair(audio, standard, d)
    cwd = os.getcwd()
    os.chdir(cli)      # compare-three writes into the working directory
    try:
        for argv in (["compare-baseline", "--baseline", ip, "--candidates",
                      op, "--outdir", "base", "--max_minutes", "1"],
                     ["compare-three", "--base", ip, "--cand", op,
                      "--plot_sec", "60", "--max_sec_spec", "60"],
                     ["compare-diff-spectrum", "--base", ip, "--cand", op,
                      "--max_minutes", "1"],
                     ["plot-diff", "-i", "diff_spectrum.csv"],
                     ["reverse-engineer", "-i", rip, "-o", rop, "--csv",
                      "rev.csv"]):
            t0 = time.perf_counter()
            rc, out = quiet_call(cli_main.main, argv)
            if rc != 0:
                fail(f"{argv[0]}: exit {rc}\n{out[-800:]}")
            log(f"{argv[0]} on the card: exit 0 in "
                f"{time.perf_counter() - t0:.3f} s; "
                f"{out.strip().splitlines()[0][:100]}")
    finally:
        os.chdir(cwd)

    res = {}
    for dev in ("cuda", "cpu"):
        od = os.path.join(d, dev)
        os.makedirs(od)
        t0 = time.perf_counter()
        base = cs.compare_to_baseline(ip, [op], os.path.join(od, "base"),
                                      max_minutes=1.0, device=dev)[0]
        os.chdir(od)
        try:
            three = cs.compare_three(ip, [op], plot_sec=60.0,
                                     max_sec_spec=60.0, device=dev)[0]
        finally:
            os.chdir(cwd)
        diff = cs.compare_diff_spectrum(
            ip, op, max_minutes=1.0, out_csv=os.path.join(od, "diff.csv"),
            out_png=os.path.join(od, "diff.png"), device=dev)
        rev = analyze_device_params(rip, rop,
                                    out_csv=os.path.join(od, "rev.csv"),
                                    device=dev)
        res[dev] = dict(base=base, three=three, diff=diff, rev=rev,
                        wall=time.perf_counter() - t0)
    card, cpu = res["cuda"], res["cpu"]
    tol = 1e-3
    diffs = []
    b, bc = card["base"], cpu["base"]
    if b["delay"] != bc["delay"] or b["name"] != bc["name"]:
        diffs.append(f"compare-baseline delay {b['delay']} / {bc['delay']}")
    diffs += check_differences(
        {k: b[k] for k in ("gain_db", "anchor_db", "snr", "stats",
                           "music_err", "noise_delta", "delta_smooth")},
        {k: bc[k] for k in ("gain_db", "anchor_db", "snr", "stats",
                            "music_err", "noise_delta", "delta_smooth")},
        tol, "compare-baseline")
    diffs += check_differences(card["three"], cpu["three"], tol,
                               "compare-three")
    t, tc = card["diff"], cpu["diff"]
    if t["delay_samples"] != tc["delay_samples"] \
            or t["used_frames"] != tc["used_frames"]:
        diffs.append(f"compare-diff-spectrum delay/frames "
                     f"{t['delay_samples']}/{t['used_frames']} vs "
                     f"{tc['delay_samples']}/{tc['used_frames']}")
    diffs += check_differences(
        {k: t[k] for k in ("anchor_db", "delta_raw", "delta_smooth")},
        {k: tc[k] for k in ("anchor_db", "delta_raw", "delta_smooth")},
        tol, "compare-diff-spectrum")
    r, rc_ = card["rev"], cpu["rev"]
    for k in ("delay_samples", "n_frames", "histogram"):
        if r[k] != rc_[k]:
            diffs.append(f"reverse-engineer {k}: {r[k]} / {rc_[k]}")
    if len(r["level_table"]) != len(rc_["level_table"]) \
            or (r["gate_threshold"] is None) != (rc_["gate_threshold"]
                                                 is None):
        diffs.append("reverse-engineer: level table rows or threshold")
    else:
        for i, (x, y) in enumerate(zip(r["level_table"],
                                       rc_["level_table"])):
            diffs += check_differences(x, y, tol, f"level_table[{i}]")
        diffs += check_differences(
            dict(thr=r["gate_threshold"] or {}, levels=r["levels"],
                 tilts=r["tilts"]),
            dict(thr=rc_["gate_threshold"] or {}, levels=rc_["levels"],
                 tilts=rc_["tilts"]), tol, "reverse-engineer")
    for name, a, c in (("diff.csv", "diff.csv", "diff.csv"),
                       ("base/diff_out.csv", "base/diff_out.csv",
                        "base/diff_out.csv"),
                       ("rev.csv", "rev.csv", "rev.csv")):
        va = np.loadtxt(os.path.join(d, "cuda", a), delimiter=",",
                        skiprows=1)
        vc = np.loadtxt(os.path.join(d, "cpu", c), delimiter=",",
                        skiprows=1)
        # rev.csv prints levels and tilts to 0.01
        lim = 0.0100001 if name == "rev.csv" else tol
        if va.shape != vc.shape or not np.array_equal(va[:, 0], vc[:, 0]) \
                or np.max(np.abs(va - vc)) > lim:
            diffs.append(f"{name}: card and CPU rows differ")
    three_csv = [f for f in os.listdir(os.path.join(d, "cuda"))
                 if f.startswith("cmp_diff_")]
    for f in three_csv:
        va = np.loadtxt(os.path.join(d, "cuda", f), delimiter=",",
                        skiprows=1)
        vc = np.loadtxt(os.path.join(d, "cpu", f), delimiter=",",
                        skiprows=1)
        if np.max(np.abs(va - vc)) > tol:
            diffs.append(f"{f}: card and CPU rows differ")
    # plot-diff: host numpy on a CSV; on the card run's CSV it gives the
    # bands the CPU run's plotter gives on that CSV, and within 1e-3 dB of
    # the bands of the CPU run's own CSV
    plot = cs.plot_diff_spectrum(os.path.join(d, "cuda", "diff.csv"))
    plot_again = cs.plot_diff_spectrum(os.path.join(d, "cuda", "diff.csv"))
    plot_cpu = cs.plot_diff_spectrum(os.path.join(d, "cpu", "diff.csv"))
    if plot["bands"] != plot_again["bands"]:
        diffs.append("plot-diff bands differ between two runs")
    diffs += check_differences(plot["bands"], plot_cpu["bands"], tol,
                               "plot-diff")
    if r["gate_threshold"] is None:
        diffs.append("reverse-engineer: no C1/C2 separation found")
    if diffs or not three_csv:
        fail(f"comparison commands, card vs CPU: {diffs}")
    pngs = sorted(os.path.relpath(os.path.join(root, f), d)
                  for root, _, files in os.walk(d) for f in files
                  if f.endswith(".png"))
    try:
        import matplotlib  # noqa: F401
        have_mpl = "matplotlib imports"
    except ImportError:
        have_mpl = "matplotlib does not import"
    log(f"comparison commands (60 s input vs its process output; "
        f"reverse-engineer on a 60 s AR(1)-noise pair, gate at -32 dBFS), "
        f"card vs CPU: delays, frame counts, histogram and level-table counts "
        f"equal; bands, music_err {b['music_err']:.4f} / "
        f"{bc['music_err']:.4f} dB, noise_delta, CSV rows, threshold "
        f"estimate {r['gate_threshold']['estimate']:.4f} / "
        f"{rc_['gate_threshold']['estimate']:.4f} dBFS within 1e-3 dB; "
        f"plot-diff bands {plot['bands']}; walls card "
        f"{card['wall']:.3f} s, CPU {cpu['wall']:.3f} s; {have_mpl}, PNGs "
        f"written: {pngs or 'none'}")


VALIDATE_CHILD = """import sys, torch
from tomatis_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
print("cuda initialized:", torch.cuda.is_initialized())
sys.exit(rc)
"""


def console_entry():
    """The function that pyproject.toml installs as `tomatis-torch`."""
    import importlib
    import tomllib
    with open(os.path.join(HERE, "pyproject.toml"), "rb") as f:
        target = tomllib.load(f)["project"]["scripts"]["tomatis-torch"]
    mod, fn = target.split(":")
    return target, getattr(importlib.import_module(mod), fn)


def platform_runs(ip, op, cp, d: str, card: str):
    """Phase 29 (d): `validate` on the 60 s output of phase 5 in three
    child processes, side by side: TOMATIS_PLATFORM=cpu with no --device,
    --device cpu with no variable, and TOMATIS_PLATFORM=cpu with --device
    cuda. The first must print the second's console text (its verdict
    with it), write the same spectrum CSV and leave CUDA uninitialised;
    the third must initialise the card and give a verdict."""
    base = dict(os.environ, PYTHONPATH=HERE, PYTHONIOENCODING="utf-8")
    base.pop("TOMATIS_PLATFORM", None)
    env_cpu = dict(base, TOMATIS_PLATFORM="cpu")
    argv = ["validate", "-i", ip, "-o", op, "--state_csv", cp]
    runs = {"env_cpu": (env_cpu, []),
            "flag_cpu": (base, ["--device", "cpu"]),
            "env_cpu_flag_cuda": (env_cpu, ["--device", "cuda"])}
    procs = {}
    t0 = time.perf_counter()
    for name, (env, extra) in runs.items():
        cwd = os.path.join(d, name)   # validate writes its CSV here
        os.makedirs(cwd)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", VALIDATE_CHILD] + argv + extra, env=env,
            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            encoding="utf-8")
    res = {}
    try:
        for name, pr in procs.items():
            out, err = pr.communicate(timeout=600)
            res[name] = (pr.returncode, out, err)
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    wall = time.perf_counter() - t0
    inited = {}
    for name, (rc, out, err) in res.items():
        lines = out.strip().splitlines()
        if not lines or not lines[-1].startswith("cuda initialized:") \
                or rc not in (0, 1) or "Layer1 验证: " not in out:
            fail(f"validate ({name}) exited {rc} without a verdict: "
                 f"{out[-1500:]} {err[-1500:]}")
        inited[name] = lines[-1].split(":", 1)[1].strip()
    (rc_e, out_e, _), (rc_f, out_f, _) = res["env_cpu"], res["flag_cpu"]
    csvs = [os.path.join(d, n, "layer1_spectrum_check.csv")
            for n in ("env_cpu", "flag_cpu")]
    if rc_e != rc_f or out_e != out_f or not files_equal(*csvs):
        fail(f"validate under TOMATIS_PLATFORM=cpu (exit {rc_e}) differs "
             f"from --device cpu (exit {rc_f}) in its console text or CSV")
    if inited != {"env_cpu": "False", "flag_cpu": "False",
                  "env_cpu_flag_cuda": "True"}:
        fail(f"CUDA initialised in the validate children: {inited} (cpu "
             f"runs must leave it uninitialised, --device cuda set it up)")
    verdict = [ln for ln in out_e.splitlines() if "Layer1 验证" in ln][-1]
    rc_c = res["env_cpu_flag_cuda"][0]
    log(f"api: validate on the 60 s output in three child processes side by "
        f"side, {wall:.3f} s in all ({card}): TOMATIS_PLATFORM=cpu without "
        f"--device exit {rc_e} ({verdict!r}: no sidecar, so the reference "
        f"validator's defaults), the console text and spectrum "
        f"CSV of --device cpu's run (exit {rc_f}), CUDA initialised "
        f"{inited['env_cpu']} / {inited['flag_cpu']}; with --device cuda "
        f"it wins over the variable: CUDA initialised "
        f"{inited['env_cpu_flag_cuda']}, exit {rc_c}")


def api_paths(torch, cuda_ola, audio, standard, x, ip, op, cp, tmp,
              card: str) -> dict:
    """Phase 29: the package's public surface on the card. The M-minute
    programme as a WAV through (a) tomatis_tpu_torch.process and (b) the
    function pyproject.toml installs as `tomatis-torch`, running
    `process`, each byte-equal (WAV and state CSV) to
    models.standard.process on the same file with default StandardParams
    and 1024 frames per chunk, one chunk-tail launch per chunk each;
    then (d) TOMATIS_PLATFORM in child processes (platform_runs)."""
    import tomatis_tpu_torch as tt
    if tt.process is not standard.process \
            or tt.StandardParams is not standard.StandardParams:
        fail("tomatis_tpu_torch.process is not models.standard.process")
    target, entry = console_entry()
    d = os.path.join(tmp, "api")
    os.makedirs(d)
    lip = os.path.join(d, "long.wav")
    audio.write(lip, x, SR, subtype="PCM_24")
    paths = {k: (os.path.join(d, f"{k}.wav"), os.path.join(d, f"{k}.csv"))
             for k in ("reference", "top_level", "console")}

    def reference(o, c):
        return standard.process(lip, o, standard.StandardParams(),
                                state_csv_path=c, frames_per_chunk=1024,
                                device="cuda")

    def top_level(o, c):
        return tt.process(lip, o, state_csv_path=c)

    def console(o, c):
        rc, text = quiet_call(entry, ["process", "-i", lip, "-o", o,
                                      "--state_csv", c])
        for ln in text.strip().splitlines():
            log(f"api: tomatis-torch: {ln}")
        if rc != 0:
            fail(f"tomatis-torch process exited {rc}")

    launches, chunks = {}, None
    for name, fn in (("reference", reference), ("top_level", top_level),
                     ("console", console)):
        o, c = paths[name]
        torch.cuda.synchronize()
        reset_counts(cuda_ola)
        t0 = time.perf_counter()
        st = fn(o, c)
        wall = time.perf_counter() - t0
        chunks = st["chunks"] if st is not None else chunks
        launches[f"api_{name}"] = read_counts(cuda_ola, chunks, f"api {name}")
        if name != "reference" and not (
                files_equal(o, paths["reference"][0])
                and files_equal(c, paths["reference"][1])):
            fail(f"api {name}: the WAV or the state CSV differs from "
                 f"models.standard.process's bytes")
        log(f"api {name}: {len(x) / SR:.0f} s WAV to WAV, {chunks} chunks, "
            f"{launches[f'api_{name}']['chunk_tail']} chunk-tail launches "
            f"{launches[f'api_{name}']['chunk_tail_by_frames']}, no "
            f"overlap-add; wall {wall:.3f} s ({card})"
            + ("" if name == "reference" else
               "; WAV and state CSV equal the reference's bytes"))
    log(f"api: tomatis-torch resolves to {target} (pyproject.toml)")
    platform_runs(ip, op, cp, d, card)
    return launches


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
    from tomatis_tpu_torch.models import adaptive, eq, standard, xfade
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.native.build import BUILD_LOG, load_library
    from tomatis_tpu_torch.ops import cuda_ola
    from tomatis_tpu_torch.utils.stateio import read_state_csv

    # -- 2. build ------------------------------------------------------------
    # one compiler per source, started together: nvcc for the kernels,
    # the host C++ compiler for the FLAC and the wire codec
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = {"csrc/ola.cu": pool.submit(cuda_ola.build),
                "csrc/flac.cpp": pool.submit(load_library, "flac"),
                "csrc/wire.cpp": pool.submit(load_library, "wire")}
        for src, job in jobs.items():
            try:
                job.result()
            except Exception as e:   # reported, then the run fails
                fail(f"{src} did not build: {e}")
    log(f"build: {time.perf_counter() - t0:.1f} s (csrc/ola.cu with nvcc, "
        f"csrc/flac.cpp and csrc/wire.cpp with the host C++ compiler, all "
        f"started together; compiled in this run: {sorted(BUILD_LOG)}; a "
        f"library is kept only when its name's hash of the compile commands "
        f"and the host matches and it is newer than its source)")
    for src, text in BUILD_LOG.items():
        for ln in ptxas_lines(text):
            log(f"ptxas {src}: {ln}")
    from tomatis_tpu_torch.io.flac import encoder_threads
    log(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} in "
        f"this process's affinity mask; FLAC encoder helper threads "
        f"{encoder_threads()}")

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
    # the warm run's stream stages, the collected output's decode left out
    stream_alone_s = sum(v for k, v in stats["timings"].items()
                         if k != "output_decode_s")

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

    # -- 9-13. adaptive, EQ appliers, EQ resume, match, declick --------------
    launches.update(adaptive_paths(torch, cuda_ola, audio, adaptive, x, ip,
                                   tmp))
    launches.update(eq_paths(torch, cuda_ola, audio, eq, standard, x60, tmp))
    launches.update(match_path(torch, cuda_ola, audio, standard, args.seed,
                               tmp))
    declick_path(audio, tmp)

    # -- 14-17. wire codec, the long file, the threaded pipeline, convert ---
    wire_codec_phase(torch, x, args.seed)
    launches.update(thread_paths(torch, cuda_ola, audio, standard, eq, x,
                                 stream_alone_s, tmp))

    # -- 18. process-batch ---------------------------------------------------
    batched = check_batched_tail(torch, cuda_ola)
    launches.update(batch_path(torch, cuda_ola, audio, standard, x, tmp))

    # -- 19-22. doctor, verifiers, case study, analyzers --------------------
    launches.update(doctor_path(cuda_ola))
    launches.update(verifier_paths(
        torch, cuda_ola, standard, ip, os.path.join(tmp, "long.flac"),
        os.path.join(tmp, "long_pcm24.flac"),
        os.path.join(tmp, "long_pcm24.csv"), tmp))
    launches.update(case_study_path(cuda_ola, tmp))
    analyzer_paths(ip, op, cp, tmp)

    # -- 23-25. process-sharded: full size, the variants and the CLI, resume -
    launches.update(sharded_paths(torch, cuda_ola, audio, standard, x, ip,
                                  op, cp, tmp))
    # -- 26. process-batch --devices -----------------------------------------
    launches.update(batch_devices_path(torch, cuda_ola, standard, tmp))
    # -- 27. the comparison commands and reverse-engineer --------------------
    comparison_paths(audio, standard, ip, op, tmp)
    # -- 28. process-batch on wire -------------------------------------------
    launches.update(wire_batch_path(torch, cuda_ola, audio, standard, x,
                                    tmp))
    # -- 29. the package's public surface: top level, tomatis-torch, -------
    # TOMATIS_PLATFORM
    launches.update(api_paths(torch, cuda_ola, audio, standard, x, ip, op,
                              cp, tmp, card))
    tmp_dir.cleanup()

    # -- 30. result ----------------------------------------------------------
    replaces = {"chunk_tail_batched": "tomatis_tpu/ops/pallas_ola.py:75 "
                "under jax.vmap (tomatis_tpu/parallel/batch.py:272)"}
    kernels = [dict(name=name, route="cuda",
                    source="tomatis_tpu_torch/csrc/ola.cu",
                    replaces=replaces.get(
                        name, "tomatis_tpu/ops/pallas_ola.py:75"),
                    launches=sum(c[name] for c in launches.values()),
                    launches_by_path={k: c[name]
                                      for k, c in launches.items()},
                    bound_by="bytes", **res)
               for name, res in (("overlap_add", ola), ("chunk_tail", tail),
                                 ("chunk_tail_batched", batched))]
    next(k for k in kernels if k["name"] == "chunk_tail")[
        "launches_by_frames"] = {
        k: c["chunk_tail_by_frames"] for k, c in launches.items()
        if "chunk_tail_by_frames" in c}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
