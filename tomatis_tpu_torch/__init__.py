"""PyTorch/CUDA port of tomatis_tpu: the standard Tomatis processor on an
NVIDIA H100 (sm_90a), held against the JAX package as its reference.

Imports torch, numpy and the standard library only; never jax and nothing
of tomatis_tpu. The public names are tomatis_tpu's:

    import tomatis_tpu_torch as tt
    tt.process("in.flac", "out.flac", tt.StandardParams(gate_ui=50))
    y, stats = tt.process_array(x, 48000, device="cpu")

`audio` is imported at once and is torch-free; the processors resolve at
first touch, so `import tomatis_tpu_torch` and file reads through
`tomatis_tpu_torch.io` import no torch.
"""

__version__ = "0.1.0"

from tomatis_tpu_torch._lazy import lazy_getattr  # noqa: E402
from tomatis_tpu_torch.io import audio  # noqa: F401,E402

__getattr__ = lazy_getattr(__name__, {
    "StandardParams": ("tomatis_tpu_torch.models.standard", "StandardParams"),
    "process": ("tomatis_tpu_torch.models.standard", "process"),
    "process_array": ("tomatis_tpu_torch.models.standard", "process_array"),
    "XfadeParams": ("tomatis_tpu_torch.models.xfade", "XfadeParams"),
    "AdaptiveParams": ("tomatis_tpu_torch.models.adaptive", "AdaptiveParams"),
    "process_batch": ("tomatis_tpu_torch.parallel.batch", "process_batch"),
})
