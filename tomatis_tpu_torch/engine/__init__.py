"""engine of the PyTorch port (mirrors tomatis_tpu/engine/).

The streaming names import torch and resolve at first touch, so that
importing the package leaves torch out.
"""
from tomatis_tpu_torch._lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    name: ("tomatis_tpu_torch.engine.streaming", name)
    for name in ("ChunkedStftEngine", "FlushPlan", "StreamRunner",
                 "flush_plan")})
