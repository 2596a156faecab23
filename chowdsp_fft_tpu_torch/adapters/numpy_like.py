"""numpy.fft-compatible adapter (counterpart of
``chowdsp_fft_tpu/adapters/numpy_like.py``).

The port's engines under np.fft names and *scaled* conventions: ``ifft``
and ``irfft`` divide by n, unlike the core API, which is unscaled. ``n``
pads with zeros or trims the transformed axis, ``axis`` picks it. A tensor
stays on its own device; a host array (numpy, a list) goes to the card
unless ``device`` says otherwise, as the filters do
(``stream.filter_device``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import api
from ..stream.ols import filter_device

__all__ = ["fft", "ifft", "rfft", "irfft", "fftfreq", "rfftfreq"]


def _as_tensor(a, device) -> torch.Tensor:
    """``a`` on ``device``, else a tensor on its own device and anything
    else on the card."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(filter_device(a, device))


def _last_axis(a, axis: int, device) -> torch.Tensor:
    return torch.movedim(_as_tensor(a, device), axis, -1)


def _maybe_pad_or_trim(x: torch.Tensor, n: int | None) -> torch.Tensor:
    if n is None or n == x.shape[-1]:
        return x
    if n < x.shape[-1]:
        return x[..., :n]
    return F.pad(x, (0, n - x.shape[-1]))


def fft(a, n: int | None = None, axis: int = -1, engine: str = "auto", device=None) -> torch.Tensor:
    a = _maybe_pad_or_trim(_last_axis(a, axis, device), n)
    out = api.fft(a.to(torch.complex64), engine=engine)
    return torch.movedim(out, -1, axis)


def ifft(a, n: int | None = None, axis: int = -1, engine: str = "auto", device=None) -> torch.Tensor:
    a = _maybe_pad_or_trim(_last_axis(a, axis, device), n)
    out = api.ifft(a.to(torch.complex64), engine=engine) * (1.0 / a.shape[-1])
    return torch.movedim(out, -1, axis)


def rfft(a, n: int | None = None, axis: int = -1, engine: str = "auto", device=None) -> torch.Tensor:
    a = _maybe_pad_or_trim(_last_axis(a, axis, device), n)
    out = api.rfft(a.to(torch.float32), engine=engine)
    return torch.movedim(out, -1, axis)


def irfft(a, n: int | None = None, axis: int = -1, engine: str = "auto", device=None) -> torch.Tensor:
    a = _last_axis(a, axis, device)
    if n is None:
        n = 2 * (a.shape[-1] - 1)
    a = _maybe_pad_or_trim(a, n // 2 + 1).to(torch.complex64)
    if n % 2:
        # Odd n (no Nyquist bin): the half-complex core is even-only, so
        # reconstruct by Hermitian extension and a full complex inverse,
        # numpy's semantics, shape (..., n).
        full = torch.cat([a, torch.flip(a[..., 1:], [-1]).conj()], dim=-1)
        out = api.ifft(full, engine=engine).real * (1.0 / n)
    else:
        out = api.irfft(a, engine=engine) * (1.0 / n)
    return torch.movedim(out, -1, axis)


def fftfreq(n: int, d: float = 1.0, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.fft.fftfreq(n, d), dtype=torch.float32, device=device)


def rfftfreq(n: int, d: float = 1.0, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.fft.rfftfreq(n, d), dtype=torch.float32, device=device)
