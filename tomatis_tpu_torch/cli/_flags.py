"""Shared argparse flag groups (reference-compatible names/defaults).

The reference duplicates these argparse blocks in every script
(e.g. src/process_tomatis.py:488-515, src/process_tomatis_xfade.py:360-390);
here each group exists once.
"""
from __future__ import annotations

import argparse


def add_io_flags(ap: argparse.ArgumentParser):
    ap.add_argument("-i", "--input", required=True, help="input audio file")
    ap.add_argument("-o", "--output", required=True, help="output audio file")


def add_gate_flags(ap: argparse.ArgumentParser, gate_mode: bool = True):
    ap.add_argument("--gate_ui", type=float, default=50,
                    help="gate UI value (0-100)")
    if gate_mode:
        ap.add_argument("--gate_mode", choices=["linear", "log_percent"],
                        default="log_percent", help="UI->dBFS mapping")
        ap.add_argument("--dynamic_range", type=float, default=80.0,
                        help="dynamic range (dB) for log_percent mode")
    ap.add_argument("--gate_scale", type=float, default=1.0,
                    help="gate scale (linear mode)")
    ap.add_argument("--gate_offset", type=float, default=-100,
                    help="gate offset (linear mode)")
    ap.add_argument("--hyst_db", type=float, default=3.0,
                    help="hysteresis (dB)")
    ap.add_argument("--up_delay_ms", type=float, default=250.0,
                    help="C1->C2 up-switch delay (ms)")


def add_filter_flags(ap: argparse.ArgumentParser):
    ap.add_argument("--fc", type=float, default=1000.0,
                    help="pivot frequency (Hz)")
    ap.add_argument("--slope", type=float, default=12.0,
                    help="slope (dB/octave)")
    ap.add_argument("--c1_low", type=float, default=15.0)
    ap.add_argument("--c1_high", type=float, default=-15.0)
    ap.add_argument("--c2_low", type=float, default=-15.0)
    ap.add_argument("--c2_high", type=float, default=15.0)


def add_stft_flags(ap: argparse.ArgumentParser, n_fft: int = 4096,
                   hop: int = 2048):
    ap.add_argument("--n_fft", type=int, default=n_fft, help="FFT size")
    ap.add_argument("--hop", type=int, default=hop, help="hop size")


def add_engine_flags(ap: argparse.ArgumentParser):
    """Framework-only knobs (no reference counterpart)."""
    ap.add_argument("--frames_per_chunk", type=int, default=1024,
                    help="frames per device chunk step")
    ap.add_argument("--allow_any_rate", action="store_true",
                    help="skip the reference's 48kHz/stereo requirement")
