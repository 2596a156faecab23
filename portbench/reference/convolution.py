"""FIR filtering in float64 by FFT convolution, a few channels at a time
so that it fits beside the program's inputs."""

from __future__ import annotations

import torch

CHANNELS_PER_BLOCK = 8


def _fast_length(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def linear(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Zero-state FIR filtering of (C, T) streams by their own (C, taps)
    IRs, truncated to T samples, as ``scipy.signal.lfilter(h, 1, x)``
    a channel: float64 (C, T)."""
    t = x.shape[-1]
    n = _fast_length(t + h.shape[-1] - 1)
    out = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for c in range(0, x.shape[0], CHANNELS_PER_BLOCK):
        xs = torch.fft.rfft(x[c:c + CHANNELS_PER_BLOCK].double(), n=n)
        hs = torch.fft.rfft(h[c:c + CHANNELS_PER_BLOCK].double(), n=n)
        out[c:c + CHANNELS_PER_BLOCK] = torch.fft.irfft(xs * hs, n=n)[..., :t]
    return out

