"""chowdsp_fft_tpu_torch — the PyTorch and CUDA port of chowdsp_fft_tpu.

It keeps the JAX package's public layouts and entry points and runs the
transforms on hand-written Hopper kernels (``ops/hopper_fft.py``,
``csrc/*.cu``): the packed real FFT and fast convolution (K1-K3), the
complex FFT (K4), the small-N FFT (K5), the two-level composite
up to 2^20 (K6, K7a, K7b), and the pipelined forms of K1, K2 and K4
(K1-db, K2-db, K4-db; no dispatch path runs them, as in the JAX
package). Sizes outside the kernels' domain run on the plain PyTorch
Stockham engine. It imports ``torch`` and never ``jax``.

Layers:
  plans   — factorization + twiddle tables
  ops     — Stockham engine (plain torch) + Hopper engine (CUDA kernels)
  api     — the public transform/convolve surface (re-exported here)
  stream  — overlap-save FIR, polyphase resampling, channelizer, demod, STFT
  models  — the SDR receiver chain, the multichannel convolver
  parallel — meshes, halo-exchange streams and the all_to_all distributed
             FFT on torch.distributed (DTensors in and out)
  convert — carry the JAX package's plans, filters, state and models across
  adapters — numpy.fft-style and juce::dsp::FFT-style surfaces
  utils   — the native planner, profiling, the H100 roofline
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
    plan_bytes,
    rfft,
    rfft_packed,
    rfft_packed_unordered,
    rfft_unordered,
    spectrum_to_packed_planes,
    vector_width_bytes,
)

# Importing the Hopper engine registers it with the api dispatcher. It
# builds nothing at import: the kernels compile on their first CUDA launch.
from .ops import hopper_fft as _hopper_fft  # noqa: F401,E402
from .ops.hopper_fft import merge_precision  # noqa: F401,E402

__version__ = "0.1.0"
