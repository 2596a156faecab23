"""Streaming DSP built on the FFT core: overlap-save FIR convolution,
polyphase resampling, channelization, demodulation, STFT."""

from .ols import (  # noqa: F401
    PartitionedFIR,
    filter_device,
    fir_filter_ols,
    next_fft_size,
    partitioned_fir_apply,
)
from .polyphase import (  # noqa: F401
    design_lowpass,
    polyphase_decimate,
    polyphase_interpolate,
)
from .demod import am_demod, dc_block, fm_demod  # noqa: F401
from .channelizer import Channelizer, channelize  # noqa: F401
from .stft import hann_window, istft, spectrogram, stft  # noqa: F401
