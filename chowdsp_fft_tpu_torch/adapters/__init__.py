"""Migration adapters: numpy.fft-style and juce::dsp::FFT-style surfaces
(counterpart of ``chowdsp_fft_tpu/adapters``)."""

from . import numpy_like  # noqa: F401
from .juce_like import JuceStyleFFT  # noqa: F401
