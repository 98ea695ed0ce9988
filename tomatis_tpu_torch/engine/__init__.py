"""engine of the PyTorch port (mirrors tomatis_tpu/engine/)."""
