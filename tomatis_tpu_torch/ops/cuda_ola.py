"""K-way overlap-add: the hand-written CUDA kernel and its plain version.

``overlap_add_cuda`` replaces the Pallas TPU kernel
tomatis_tpu/ops/pallas_ola.py::overlap_add_pallas (csrc/ola.cu holds the
kernel and its design note). It is built with nvcc for sm_90a at first use
and launched on the current CUDA stream. A failed build or launch raises;
nothing falls back to the plain version on the card.

``overlap_add_plain`` is the reference's K shifted adds in torch: the CPU
path, the tests' oracle and the card check's yardstick.

With K = n_fft/hop, (F + K - 1)*hop == (F - 1)*hop + n_fft, so both return
exactly the L = (F-1)*hop + n_fft rows of stft.overlap_add.
"""
from __future__ import annotations

import ctypes

import torch


def _check_hop(y: torch.Tensor, hop: int):
    if y.ndim != 3:
        raise ValueError(f"expected frames [F, C, n_fft], got {tuple(y.shape)}")
    F, C, n_fft = y.shape
    if hop <= 0 or n_fft % hop:
        raise ValueError("the K-way overlap-add requires hop | n_fft")
    return F, C, n_fft, n_fft // hop


def overlap_add_plain(y: torch.Tensor, hop: int) -> torch.Tensor:
    """y [F, C, n_fft] -> [(F+K-1)*hop, C], K shifted adds."""
    F, C, n_fft, k = _check_hop(y, hop)
    yb = y.reshape(F, C, k, hop)
    out = torch.zeros((F + k - 1, C, hop), dtype=torch.float32,
                      device=y.device)
    for i in range(k):
        out[i:i + F] += yb[:, :, i, :]
    return out.permute(0, 2, 1).reshape((F + k - 1) * hop, C)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from tomatis_tpu_torch.native.build import load_library
        lib = load_library("ola")
        lib.tomatis_ola_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tomatis_ola_f32.restype = ctypes.c_int
        lib.tomatis_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tomatis_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (if stale) and load the kernel library."""
    _lib()


def overlap_add_cuda(y: torch.Tensor, hop: int) -> torch.Tensor:
    """y [F, C, n_fft] float32 on CUDA -> [(F+K-1)*hop, C] on CUDA.

    Counts each launch in ``overlap_add_cuda.launches``."""
    F, C, n_fft, k = _check_hop(y, hop)
    if not y.is_cuda:
        raise ValueError("overlap_add_cuda takes a CUDA tensor")
    if y.dtype != torch.float32:
        raise TypeError(f"overlap_add_cuda takes float32, got {y.dtype}")
    y = y.contiguous()
    out = torch.empty(((F + k - 1) * hop, C), dtype=torch.float32,
                      device=y.device)
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.tomatis_ola_f32(y.data_ptr(), out.data_ptr(), F, C, n_fft,
                                  hop, stream)
    if err:
        raise RuntimeError("overlap-add kernel launch failed: "
                           + lib.tomatis_cuda_error_string(err).decode())
    overlap_add_cuda.launches += 1
    return out


overlap_add_cuda.launches = 0
