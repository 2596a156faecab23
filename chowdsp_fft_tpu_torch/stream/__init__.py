"""Streaming DSP built on the FFT core: overlap-save FIR convolution."""

from .ols import (  # noqa: F401
    PartitionedFIR,
    fir_filter_ols,
    next_fft_size,
    partitioned_fir_apply,
)
