"""Measurement tools of the PyTorch + CUDA port (not part of the package)."""
