"""ops of the PyTorch port (mirrors tomatis_tpu/ops/).

dsp, gate and stft import torch and resolve at first touch, so that
importing the package, or the torch-free ops.wire, leaves torch out.
"""
from tomatis_tpu_torch._lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    name: (f"{__name__}.{name}", None) for name in ("dsp", "gate", "stft")})
