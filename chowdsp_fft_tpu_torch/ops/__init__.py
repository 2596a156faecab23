"""Compute engines and frequency-domain ops: the plain PyTorch Stockham
engine and the Hopper kernels (``hopper_fft``, built from ``csrc/``)."""
