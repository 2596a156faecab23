"""juce::dsp::FFT-style adapter (counterpart of
``chowdsp_fft_tpu/adapters/juce_like.py``).

Power-of-two order, a complex ``perform`` with 1/N scaling on the inverse,
and the real-only transforms in JUCE's layout: N/2 + 1 complex bins
interleaved in N + 2 floats. Every order runs on the engine ``auto`` picks
(orders below 5, which JUCE hands to other engines, included). The JAX
adapter jits its methods per input shape; here the per-shape state is the
plan, which ``cached_plan`` keeps. A tensor stays on its own device; a
host array goes to ``device``, by default the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import api
from ..ops import layout
from .numpy_like import _as_tensor

__all__ = ["JuceStyleFFT"]


class JuceStyleFFT:
    """Behavioural match for juce::dsp::FFT on the port's engines, batched
    over leading axes."""

    PRIORITY = 7  # the reference adapter registers itself at priority 7

    def __init__(self, order: int, engine: str = "auto", device=None):
        if order < 0:
            raise ValueError("order must be >= 0")
        self.order = order
        self.size = 1 << order
        self.engine = engine
        self.device = device

    def get_size(self) -> int:
        return self.size

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        return _as_tensor(a, self.device).to(dtype)

    # -- complex ---------------------------------------------------------

    def perform(self, z, inverse: bool = False) -> torch.Tensor:
        """(..., size) complex -> (..., size) complex. The inverse is
        scaled by 1/size (JUCE's convention)."""
        z = self._tensor(z, torch.complex64)
        if inverse:
            return api.ifft(z, engine=self.engine) * (1.0 / self.size)
        return api.fft(z, engine=self.engine)

    # -- real ------------------------------------------------------------

    def perform_real_only_forward_transform(self, x) -> torch.Tensor:
        """(..., size) float -> (..., size + 2) floats holding size/2 + 1
        interleaved complex bins (JUCE's real layout)."""
        spec = api.rfft(self._tensor(x, torch.float32), engine=self.engine)
        return layout.interleave_complex(spec)

    def perform_real_only_inverse_transform(self, buf) -> torch.Tensor:
        """(..., size + 2) floats in JUCE's layout -> (..., size) float,
        scaled by 1/size."""
        spec = layout.deinterleave_complex(self._tensor(buf, torch.float32))
        return api.irfft(spec, engine=self.engine) * (1.0 / self.size)

    def perform_frequency_only_forward_transform(self, x) -> torch.Tensor:
        """Magnitude spectrum, zero-padded to size floats."""
        mags = api.rfft(self._tensor(x, torch.float32), engine=self.engine).abs()
        pad = self.size - mags.shape[-1]
        if pad > 0:
            mags = F.pad(mags, (0, pad))
        return mags.to(torch.float32)
