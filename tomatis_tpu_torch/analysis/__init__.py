"""Analysis stage of the PyTorch port (alignment, spectra, calibration)."""
