"""ops of the PyTorch port (mirrors tomatis_tpu/ops/)."""
