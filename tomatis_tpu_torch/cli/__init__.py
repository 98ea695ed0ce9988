"""cli of the PyTorch port (mirrors tomatis_tpu/cli/)."""
