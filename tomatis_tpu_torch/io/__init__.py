"""io of the PyTorch port (mirrors tomatis_tpu/io/); torch-free."""
from tomatis_tpu_torch.io.audio import AudioFile, info, read, write  # noqa: F401
