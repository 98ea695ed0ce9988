"""Many files or shards per device step: parallel/batch.py (file lanes on
one card), parallel/sharded.py and parallel/stream.py (a mesh of
devices). The sharded names import torch and resolve at first touch."""
from tomatis_tpu_torch._lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    name: ("tomatis_tpu_torch.parallel.sharded", name)
    for name in ("make_mesh", "sharded_process_step")})
