"""native of the PyTorch port (mirrors tomatis_tpu/native/)."""
