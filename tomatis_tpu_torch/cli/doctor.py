"""CLI: environment verifier of the PyTorch port, counterpart of
tomatis_tpu/cli/doctor.py (capability parity with ref src/test_environment.py
+ src/test_audio.py): dependency imports, the CUDA device, the native
builds, one chunk-tail kernel launch against its plain version, the codec
round trips, an STFT check and an engine run.

    python -m tomatis_tpu_torch.cli.main doctor [--device cpu]

The checks run on --device (default cuda). Without a card, the device
check fails and the command exits 1 unless --device cpu or --skip_device
(which runs the compute checks on the CPU and says so) is given.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading


def _probe_card(timeout: float) -> str:
    """Name, count and power limit of the CUDA device, time-boxed: a
    CUDA runtime that hangs on attach is reported, not reproduced. The probe
    thread is a daemon; if it is still stuck at exit it dies with the
    process."""
    res: dict = {}

    def probe():
        try:
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available (pass --device cpu to "
                    "check the CPU path, or --skip_device)")
            res["ok"] = (f"{torch.cuda.device_count()} x "
                         f"{torch.cuda.get_device_name(0)}, torch "
                         f"{torch.__version__}, CUDA {torch.version.cuda}")
        except Exception as e:
            res["err"] = e

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=timeout)
    if t.is_alive():
        raise TimeoutError(f"no CUDA device after {timeout:.0f}s: the "
                           "CUDA runtime may be hung (rerun with --skip_device)")
    if "err" in res:
        raise res["err"]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else "not readable"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "not readable"
    return f"{res['ok']}, power limit {limit}"


def _kernel_vs_plain(dev) -> str:
    """One chunk_tail_cuda launch (pcm24, [16, 2, 4096], hop 2048) held bit
    for bit against chunk_tail_plain on the same inputs."""
    import numpy as np
    import torch
    from tomatis_tpu_torch.ops import cuda_ola
    gen = torch.Generator(device=dev).manual_seed(0)
    F, C, n_fft, hop = 16, 2, 4096, 2048
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(dev)
    kw = dict(
        z=0.05 * torch.randn((F, C, n_fft), generator=gen, device=dev),
        win=win, win2=win * win,
        out_tail=0.05 * torch.randn((n_fft - hop, C), generator=gen,
                                    device=dev),
        w_tail=torch.rand((n_fft - hop,), generator=gen, device=dev),
        gain_lin=torch.tensor(0.9, dtype=torch.float32, device=dev),
        n_valid=F - 3, transport="pcm24")
    got = cuda_ola.chunk_tail_cuda(**kw)
    want = cuda_ola.chunk_tail_plain(**kw)
    names = ("out", "peaks", "pcm", "ola_carry", "w_carry")
    bad = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"chunk_tail_cuda differs from its plain "
                             f"version in {bad}")
    return f"chunk_tail_cuda == chunk_tail_plain bit for bit ({F} frames)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch doctor",
        description="Verify the runtime environment end to end")
    ap.add_argument("--device", default="cuda",
                    help="torch device to check and run on (cuda, cuda:N "
                         "or cpu)")
    ap.add_argument("--skip_device", action="store_true",
                    help="skip the CUDA device, kernel build and kernel "
                         "checks; the compute checks run on the CPU")
    ap.add_argument("--device_timeout", type=float, default=60.0,
                    help="seconds to wait for the CUDA device before "
                         "reporting it as down (default 60)")
    args = ap.parse_args(argv)
    on_card = not args.skip_device and not args.device.startswith("cpu")
    dev = args.device if on_card else "cpu"
    ok = True
    card: dict = {}    # "up": the device check passed

    def check(name, fn, needs_card=False):
        nonlocal ok
        try:
            if needs_card and on_card and not card.get("up"):
                raise RuntimeError("the CUDA device check failed")
            detail = fn()
            print(f"[OK]   {name}" + (f": {detail}" if detail else ""))
        except Exception as e:
            ok = False
            print(f"[FAIL] {name}: {e}")

    def imports():
        import numpy
        import scipy
        import torch
        return (f"torch {torch.__version__}, numpy {numpy.__version__}, "
                f"scipy {scipy.__version__}")

    check("imports (torch/numpy/scipy)", imports)

    def optional():
        mods = []
        for m in ("matplotlib",):
            try:
                __import__(m)
                mods.append(m)
            except ImportError:
                pass
        return ", ".join(mods) or "none"

    check("optional (matplotlib)", optional)

    def device():
        if args.skip_device:
            return "skipped (--skip_device: compute checks on cpu)"
        if not on_card:
            return "not used (--device cpu)"
        detail = _probe_card(args.device_timeout)
        card["up"] = True
        return detail

    check("CUDA device", device)

    def builds():
        from tomatis_tpu_torch.native.build import load_library
        done = []
        if on_card:
            from tomatis_tpu_torch.ops import cuda_ola
            cuda_ola.build()
            done.append("csrc/ola.cu (nvcc)")
        for name in ("flac", "wire"):
            load_library(name)
            done.append(f"csrc/{name}.cpp")
        return ", ".join(done) + " built and loaded"

    check("native builds", builds)

    def kernel():
        if not on_card:
            return "skipped (no card in use)"
        return _kernel_vs_plain(dev)

    check("chunk-tail kernel", kernel, needs_card=True)

    def codecs():
        import numpy as np
        from tomatis_tpu_torch.io import audio
        x = (0.1 * np.sin(2 * np.pi * 440 * np.arange(4800) / 48000))
        x = np.stack([x, x], 1).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            for ext in ("wav", "flac"):
                p = os.path.join(d, f"t.{ext}")
                audio.write(p, x, 48000, subtype="PCM_24")
                y, sr = audio.read(p)
                if sr != 48000 or y.shape != x.shape \
                        or float(np.max(np.abs(y - x))) >= 2e-7:
                    raise AssertionError(f"{ext} round trip changed the "
                                         "samples")
        return "WAV + FLAC round trips"

    check("audio codecs", codecs)

    def wire():
        import numpy as np
        from tomatis_tpu_torch.io import wirecodec
        rng = np.random.default_rng(0)
        v = rng.integers(-100000, 100000, (5000, 2)).astype(np.int32)
        buf = wirecodec.encode_i32(v)
        if not np.array_equal(wirecodec.decode_i32(buf, 5000, 2), v):
            raise AssertionError("wire round trip changed the samples")
        native = "native" if wirecodec.available() else "numpy fallback"
        return (f"{native}, {len(buf) / (v.size * 3):.2f}x of raw PCM_24 "
                "round trip")

    check("wire link codec", wire)

    def stft_smoke():
        import numpy as np
        import torch
        from tomatis_tpu_torch.ops import dsp, stft
        sr, n_fft, hop = 48000, 1024, 512
        t = np.arange(sr) / sr
        x = np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1).astype(np.float32)
        F = stft.num_frames(len(x), n_fft, hop)
        win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(dev)
        fr = stft.frame_signal(torch.from_numpy(x).to(dev), n_fft, hop, F)
        lv = dsp.frame_levels_dbfs(fr.permute(0, 2, 1))
        peak_bin = int(torch.argmax(torch.abs(torch.fft.rfft(fr[2, 0] * win))))
        f_peak = peak_bin * sr / n_fft
        if abs(f_peak - 440) >= sr / n_fft or abs(float(lv[2]) + 3.0) >= 0.5:
            raise AssertionError(f"peak {f_peak:.0f} Hz, level "
                                 f"{float(lv[2]):.2f} dBFS")
        return f"440 Hz sine -> bin {peak_bin} ({f_peak:.0f} Hz) on {dev}"

    check("STFT smoke test", stft_smoke, needs_card=True)

    def engine_smoke():
        import numpy as np
        from tomatis_tpu_torch.models.standard import (StandardParams,
                                                       process_array)
        x = (0.05 * np.random.default_rng(0).standard_normal((48000, 2))
             ).astype(np.float32)
        y, stats = process_array(x, 48000,
                                 StandardParams(require_48k_stereo=False),
                                 frames_per_chunk=16, device=dev)
        if y.shape != x.shape:
            raise AssertionError(f"output shape {y.shape}")
        return f"{stats['n_frames']} frames processed on {dev}"

    check("streaming engine", engine_smoke, needs_card=True)

    print()
    print("environment " + ("OK" if ok else "NOT OK"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
