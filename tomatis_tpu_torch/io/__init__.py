"""io of the PyTorch port (mirrors tomatis_tpu/io/)."""
