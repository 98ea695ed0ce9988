"""utils of the PyTorch port (mirrors tomatis_tpu/utils/)."""
