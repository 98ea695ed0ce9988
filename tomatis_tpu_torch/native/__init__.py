"""native of the PyTorch port (mirrors tomatis_tpu/native/); torch-free."""
from tomatis_tpu_torch.native.build import load_library  # noqa: F401
