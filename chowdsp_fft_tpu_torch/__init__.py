"""chowdsp_fft_tpu_torch — the PyTorch and CUDA port of chowdsp_fft_tpu.

It keeps the JAX package's public layouts and entry points and runs the
transforms on hand-written Hopper kernels (``ops/hopper_fft.py``,
``csrc/*.cu``): the packed real FFT and fast convolution (K1-K3), the
complex FFT (K4) and the small-N direct DFT (K5); every other size runs
on the plain PyTorch Stockham engine. It imports ``torch`` and never
``jax``.

Layers:
  plans   — factorization + twiddle tables
  ops     — Stockham engine (plain torch) + Hopper engine (CUDA kernels)
  api     — the public transform/convolve surface (re-exported here)
  stream  — overlap-save FIR, polyphase resampling, channelizer, demod
  models  — the SDR receiver chain
  convert — carry the JAX package's plans, filters and state across
"""

from .api import (  # noqa: F401
    FFT_BACKWARD,
    FFT_COMPLEX,
    FFT_FORWARD,
    FFT_REAL,
    FFTPlan,
    InvalidSizeError,
    accumulate,
    available_engines,
    cached_plan,
    convolve_accumulate,
    convolve_accumulate_packed,
    convolve_irfft_packed,
    engine_for,
    engine_supports,
    factorize,
    fft,
    fft_planes,
    fft_planes_unordered,
    fft_unordered,
    ifft,
    ifft_planes,
    ifft_planes_unordered,
    ifft_unordered,
    irfft,
    irfft_packed,
    irfft_packed_unordered,
    irfft_unordered,
    is_valid_size,
    make_plan,
    multiply_spectra,
    packed_planes_to_spectrum,
    rfft,
    rfft_packed,
    rfft_packed_unordered,
    rfft_unordered,
    spectrum_to_packed_planes,
)

# Importing the Hopper engine registers it with the api dispatcher. It
# builds nothing at import: the kernels compile on their first CUDA launch.
from .ops import hopper_fft as _hopper_fft  # noqa: F401,E402

__version__ = "0.1.0"
