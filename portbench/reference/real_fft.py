"""The packed real FFT in float64."""

from __future__ import annotations

import torch


def rfft_packed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) real rows -> float64 packed planes ((..., N/2) re, im):
    re[k], im[k] hold bin k for 0 < k < N/2; re[0] is the DC bin and
    im[0] the Nyquist bin (both real)."""
    spec = torch.fft.rfft(x.double(), dim=-1)
    re = spec.real[..., :-1].clone()
    im = spec.imag[..., :-1].clone()
    im[..., 0] = spec.real[..., -1]
    return re, im
