"""models of the PyTorch port (mirrors tomatis_tpu/models/)."""
