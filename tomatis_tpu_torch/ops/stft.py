"""Framed STFT filter bank + overlap-add, PyTorch port of
tomatis_tpu/ops/stft.py.

All frames of a chunk are one tensor:

    frames [F, C, n_fft] --rfft--> [F, C, bins] --*gain--> --irfft*win-->
    y [F, C, n_fft] --overlap-add--> [(F-1)*hop + n_fft, C]

The FFTs are torch.fft (cuFFT on the card). The overlap-add is the K-way
kernel of ops/cuda_ola.py on a CUDA tensor when hop | n_fft, its plain
version on a CPU tensor, and an index_add_ scatter otherwise.

Window convention: the processors use the *symmetric* Hann window
(np.hanning). ``torch.hann_window`` defaults to the periodic one, so the
windows are built here with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.ops import cuda_ola
from tomatis_tpu_torch.ops.dsp import frame_levels_dbfs


def hann_symmetric(n_fft: int) -> np.ndarray:
    """np.hanning: w[k] = 0.5 - 0.5*cos(2*pi*k/(n-1)), float32."""
    return np.hanning(n_fft).astype(np.float32)


def hann_periodic(n_fft: int) -> np.ndarray:
    """Periodic Hann (scipy get_window('hann', n, fftbins=True))."""
    k = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frames the reference loop emits over n_samples: starts 0, hop, ...
    while start + n_fft <= n_samples."""
    if n_samples < n_fft:
        return 0
    return (n_samples - n_fft) // hop + 1


def pad_end(n_samples: int, n_fft: int, hop: int) -> int:
    """Tail zero-padding so the last samples are frame-covered:
    (hop - ((N - n_fft) % hop)) % hop, N a sample count."""
    return (hop - ((n_samples - n_fft) % hop)) % hop


def rfft_freqs(n_fft: int, sr: float) -> np.ndarray:
    return np.fft.rfftfreq(n_fft, d=1.0 / sr).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int,
                 n_frames: int) -> torch.Tensor:
    """x [S, C] with S >= (n_frames-1)*hop + n_fft -> frames [F, C, n_fft].

    K stacked slices of hop-blocks when hop | n_fft, else one gather."""
    if n_fft % hop == 0:
        k = n_fft // hop
        n_blocks = n_frames + k - 1
        blocks = x[: n_blocks * hop].reshape(n_blocks, hop, -1)
        frames = torch.cat([blocks[i:i + n_frames] for i in range(k)],
                           dim=1)                          # [F, n_fft, C]
    else:
        idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
               + torch.arange(n_fft, device=x.device)[None, :])
        frames = x[idx]                                    # [F, n_fft, C]
    return frames.permute(0, 2, 1)                         # [F, C, n_fft]


def apply_gain_bank(frames: torch.Tensor, win: torch.Tensor,
                    gains: torch.Tensor) -> torch.Tensor:
    """Window -> rFFT -> per-bin gain -> irFFT -> window, batched.

    frames [F, C, n_fft]; win [n_fft]; gains [F, bins] or [bins], real.
    Returns y [F, C, n_fft] float32."""
    n_fft = frames.shape[-1]
    X = torch.fft.rfft(frames * win)                       # [F, C, bins]
    Y = X * (gains if gains.ndim == 1 else gains[:, None, :])
    return torch.fft.irfft(Y, n=n_fft).to(torch.float32) * win


def overlap_add(y: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add frames y [F, C, n_fft] -> [(F-1)*hop + n_fft, C].

    hop | n_fft: the CUDA kernel for a CUDA tensor, its plain version for
    a CPU tensor (the two compute the same sums in the same order).
    Otherwise an index_add_ scatter on any device, as the reference's
    XLA scatter."""
    F, C, n_fft = y.shape
    if n_fft % hop == 0:
        if y.is_cuda:
            return cuda_ola.overlap_add_cuda(y, hop)
        return cuda_ola.overlap_add_plain(y, hop)
    L = (F - 1) * hop + n_fft
    idx = (torch.arange(F, device=y.device)[:, None] * hop
           + torch.arange(n_fft, device=y.device)[None, :]).reshape(-1)
    flat = y.permute(0, 2, 1).reshape(-1, C)
    return torch.zeros((L, C), dtype=torch.float32,
                       device=y.device).index_add_(0, idx, flat)


def window_ola(win2: torch.Tensor, n_frames: int, hop: int) -> torch.Tensor:
    """Overlap-added window-square envelope (the OLA normaliser), [L]."""
    y = win2.expand(n_frames, 1, win2.shape[0]).contiguous()
    return overlap_add(y, hop)[:, 0]


def frame_levels_chunk(sig: torch.Tensor, n_fft: int, hop: int,
                       n_frames: int) -> torch.Tensor:
    """Per-frame RMS dBFS of a [S, C] signal slice."""
    frames = frame_signal(sig, n_fft, hop, n_frames)
    return frame_levels_dbfs(frames.permute(0, 2, 1))
