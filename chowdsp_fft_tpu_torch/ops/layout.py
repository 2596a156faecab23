"""Spectrum layout converters (counterpart of ``chowdsp_fft_tpu/ops/layout.py``).

The canonical real-transform spectrum is numpy-style: N//2 + 1 complex
bins. Packed planes are two (..., N/2) float32 tensors with DC in re[0]
and Nyquist in im[0]. The pffft layout is N floats
[DC, Nyquist, re1, im1, re2, im2, ...]. Complex spectra interleave re/im
floats in the C library; here they are complex64 tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "to_packed_real_spectrum",
    "from_packed_real_spectrum",
    "spectrum_to_packed_planes",
    "packed_planes_to_spectrum",
    "interleave_complex",
    "deinterleave_complex",
]


def spectrum_to_packed_planes(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical (..., N//2+1) complex spectrum -> packed planes
    ((..., N/2) f32 re, (..., N/2) f32 im) with Nyquist stored in im[0]."""
    re = spec[..., :-1].real.to(torch.float32)
    nyq = spec[..., -1:].real.to(torch.float32)
    im = torch.cat([nyq, spec[..., 1:-1].imag.to(torch.float32)], dim=-1)
    return re.contiguous(), im


def packed_planes_to_spectrum(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`spectrum_to_packed_planes`."""
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    nyq = im[..., :1]
    zeros = torch.zeros_like(nyq)
    main = torch.complex(re, torch.cat([zeros, im[..., 1:]], dim=-1))
    return torch.cat([main, torch.complex(nyq, zeros)], dim=-1)


def to_packed_real_spectrum(spec: torch.Tensor) -> torch.Tensor:
    """Canonical (..., N//2+1) complex spectrum -> pffft-style packed
    (..., N) float32: [DC, Nyquist, re1, im1, re2, im2, ...]."""
    n = 2 * (spec.shape[-1] - 1)
    dc = spec[..., :1].real
    nyq = spec[..., -1:].real
    mids = spec[..., 1:-1]
    inter = torch.stack([mids.real, mids.imag], dim=-1).reshape(*spec.shape[:-1], n - 2)
    return torch.cat([dc, nyq, inter], dim=-1).to(torch.float32)


def from_packed_real_spectrum(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_packed_real_spectrum`."""
    n = packed.shape[-1]
    packed = packed.to(torch.float32)
    dc = packed[..., 0:1]
    nyq = packed[..., 1:2]
    mids = packed[..., 2:].reshape(*packed.shape[:-1], n // 2 - 1, 2)
    zeros = torch.zeros_like(dc)
    return torch.cat(
        [
            torch.complex(dc, zeros),
            torch.complex(mids[..., 0], mids[..., 1]),
            torch.complex(nyq, zeros),
        ],
        dim=-1,
    )


def interleave_complex(z: torch.Tensor) -> torch.Tensor:
    """(..., N) complex -> (..., 2N) float32 interleaved re/im."""
    out = torch.stack([z.real, z.imag], dim=-1)
    return out.reshape(*z.shape[:-1], 2 * z.shape[-1]).to(torch.float32)


def deinterleave_complex(x: torch.Tensor) -> torch.Tensor:
    """(..., 2N) float32 interleaved -> (..., N) complex64."""
    v = x.to(torch.float32).reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.complex(v[..., 0], v[..., 1])
