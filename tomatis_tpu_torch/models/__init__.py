"""models of the PyTorch port (mirrors tomatis_tpu/models/); `standard`
imports torch and resolves at first touch."""
from tomatis_tpu_torch._lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    "standard": ("tomatis_tpu_torch.models.standard", None)})
