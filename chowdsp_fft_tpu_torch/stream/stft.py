"""Short-time Fourier transform and its inverse (PyTorch counterpart of
``chowdsp_fft_tpu/stream/stft.py``).

Frames come from the overlap-save framing (``ols._frame_overlap``: whole
row reshapes, slices and one concat, no gather); the frame transforms are
one batched ``api.rfft``/``api.irfft`` call, which the Hopper engine runs
on K1/K2 in natural order at the usual sizes; synthesis is a weighted
overlap-add of k = n_fft / hop aligned slice-adds, normalised by the COLA
table computed on the host in float64.

Conventions are the JAX package's: unscaled transforms, and
``istft(stft(x)) == x`` (the 1/N and the window normalisation are folded
into synthesis).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import api
from .ols import _frame_overlap

__all__ = ["hann_window", "stft", "istft", "spectrogram"]


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (COLA at hop = n/2, n/4, ...), as a host numpy
    array: :func:`istft` folds the window into a host-side COLA table."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _check_hop(n_fft: int, hop: int | None) -> int:
    hop = hop or n_fft // 2
    if n_fft % hop:
        raise ValueError("hop must divide n_fft")
    return hop


def stft(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int | None = None,
    window: torch.Tensor | np.ndarray | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """(..., T) real -> (..., frames, n_fft//2+1) complex64 spectra, on
    ``x``'s device.

    Frame f covers x[f*hop - pad : f*hop - pad + n_fft], pad = n_fft - hop,
    zeros outside, so every sample appears in n_fft/hop frames. ``window``
    may be a tensor or an array (default: :func:`hann_window`).
    """
    hop = _check_hop(n_fft, hop)
    x = torch.as_tensor(x, dtype=torch.float32)
    window = hann_window(n_fft) if window is None else window
    window = torch.as_tensor(window, dtype=torch.float32, device=x.device)
    pad = n_fft - hop
    # The right pad puts the tail in n_fft/hop frames; _frame_overlap's
    # left pad of `pad` zeros is the matching left boundary.
    xp = F.pad(x, (0, pad))
    frames = _frame_overlap(xp, hop, pad) * window
    plan = api.cached_plan(n_fft, api.FFT_REAL)
    return api.rfft(frames, plan=plan, engine=engine)


def istft(
    spec: torch.Tensor,
    hop: int | None = None,
    window: torch.Tensor | np.ndarray | None = None,
    length: int | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """Inverse of :func:`stft` (weighted overlap-add, COLA-normalised):
    (..., frames, n_fft//2+1) -> (..., T). The window is taken to the host,
    where its COLA table is computed in float64."""
    n_fft = 2 * (spec.shape[-1] - 1)
    hop = _check_hop(n_fft, hop)
    if window is None:
        window = hann_window(n_fft)
    elif isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    window = np.asarray(window, np.float32)
    dev = spec.device
    plan = api.cached_plan(n_fft, api.FFT_REAL)
    frames = api.irfft(spec, plan=plan, engine=engine) * (1.0 / n_fft)
    frames = frames * torch.from_numpy(window).to(dev)  # weighted OLA: the window twice

    nf = frames.shape[-2]
    k = n_fft // hop
    t_pad = (nf - 1) * hop + n_fft
    lead = frames.shape[:-2]
    # Overlap-add as k aligned slice-adds: chunk j of frame f lands at
    # offset (f + j) * hop.
    chunks = frames.reshape(*frames.shape[:-1], k, hop)
    out = torch.zeros((*lead, t_pad), dtype=torch.float32, device=dev)
    for j in range(k):
        out[..., j * hop : j * hop + nf * hop] += chunks[..., :, j, :].reshape(*lead, nf * hop)

    # COLA normalisation: the sum of squared windows at each output phase.
    w2 = window.astype(np.float64) ** 2
    cola = np.zeros(hop, np.float64)
    for j in range(k):
        cola += w2[j * hop : (j + 1) * hop]
    if cola.min() <= 1e-12:
        raise ValueError("window does not satisfy COLA at this hop")
    norm = torch.from_numpy(np.tile(1.0 / cola, t_pad // hop).astype(np.float32)).to(dev)
    out = out * norm

    pad = n_fft - hop
    out = out[..., pad : t_pad - pad]
    if length is not None:
        out = out[..., :length]
    return out


def spectrogram(
    x: torch.Tensor, n_fft: int = 1024, hop: int | None = None, engine: str = "auto"
) -> torch.Tensor:
    """Power spectrogram |STFT|^2 -> (..., frames, n_fft//2+1) float32."""
    s = stft(x, n_fft=n_fft, hop=hop, engine=engine)
    return s.real**2 + s.imag**2
