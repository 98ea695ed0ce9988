"""Verifiers of the PyTorch port (counterpart of tomatis_tpu.verify)."""
