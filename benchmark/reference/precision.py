"""The roundings a reference module's render() puts after each stage
(its `quantise` argument): the identity for the reference, a round trip
through bfloat16 for the lower-precision control, float32 (with the FFTs
computed in float32, as its `fft32` attribute asks) for a witness of
what float32 arithmetic gives, as the program's does."""
from __future__ import annotations

import torch


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bfloat16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (real and imaginary parts apart)."""
    if t.is_complex():
        return torch.complex(bfloat16(t.real), bfloat16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


def float32(t: torch.Tensor) -> torch.Tensor:
    """Round to float32 and back; render() also runs its FFTs in float32
    under this quantiser (fft32)."""
    if t.is_complex():
        return torch.complex(float32(t.real), float32(t.imag))
    return t.to(torch.float32).to(t.dtype)


float32.fft32 = True
