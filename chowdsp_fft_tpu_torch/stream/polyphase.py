"""Polyphase FIR decimation / interpolation (PyTorch counterpart of
``chowdsp_fft_tpu/stream/polyphase.py``).

Part of the SDR receiver chain (BASELINE config 5). The convolutions are
``torch.nn.functional.conv1d`` / ``conv_transpose1d`` (the JAX package
leaves them to ``lax.conv_general_dilated``, outside any Pallas kernel).
On a CUDA tensor they run through cuDNN, which takes float32 convolutions
through TF32 by default (~1e-3 relative error, the analog of the TPU's
bf16 default the JAX package overrides with ``Precision.HIGHEST``); every
convolution here runs under :func:`fp32_convolutions`, which turns TF32
off for its own duration only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tracing import spanned
from .ols import _frame_overlap

__all__ = ["polyphase_decimate", "polyphase_interpolate", "design_lowpass", "fp32_convolutions"]


@contextlib.contextmanager
def fp32_convolutions():
    """Run the enclosed cuDNN convolutions in full float32 (no TF32) and
    restore the caller's setting afterwards."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def design_lowpass(
    taps: int, cutoff: float, window: str = "hamming", device: torch.device | str = "cuda"
) -> torch.Tensor:
    """Windowed-sinc low-pass FIR design (cutoff in normalized Nyquist
    units, 0..1), computed in float64 and returned as float32 on
    ``device`` (the card unless told otherwise): the JAX package's
    ``design_lowpass``, value for value."""
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    if window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(taps) / (taps - 1))
    elif window == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2 * np.pi * np.arange(taps) / (taps - 1))
            + 0.08 * np.cos(4 * np.pi * np.arange(taps) / (taps - 1))
        )
    else:
        w = np.ones(taps)
    h = h * w
    h = h / h.sum()
    return torch.tensor(h, dtype=torch.float32, device=device)


def _conv_valid(x: torch.Tensor, h: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided valid convolution of (B, T) with (taps,) -> (B, T_out)."""
    with fp32_convolutions():
        out = F.conv1d(x[:, None, :], torch.flip(h, (-1,))[None, None, :], stride=stride)
    return out[:, 0, :]


@spanned("stream.polyphase.decimate")
def polyphase_decimate(x: torch.Tensor, h: torch.Tensor, factor: int, block: int = 4096) -> torch.Tensor:
    """Decimate (..., T) by ``factor`` after FIR anti-alias filtering.

    Equivalent to scipy.signal.upfirdn(h, x, 1, factor) restricted to the
    first T//factor outputs (zero initial state). Long streams are framed
    into overlapped ``block``-sample rows, so the convolution runs with a
    large batch dimension."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    taps = h.shape[-1]
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if t <= 2 * block:
        xb = F.pad(xb, (taps - 1, 0))  # zero initial state
        y = _conv_valid(xb, h, stride=factor)[..., : t // factor]
        return y.reshape(*batch_shape, -1)
    blk = block - block % factor  # frame starts stay phase-aligned
    frames = _frame_overlap(xb, blk, taps - 1)  # (B, nb, taps-1+blk)
    nb = frames.shape[-2]
    y = _conv_valid(frames.reshape(b * nb, -1), h, stride=factor)
    y = y.reshape(b, nb * (blk // factor))[..., : t // factor]
    return y.reshape(*batch_shape, -1)


def _interp_rows(xb: torch.Tensor, h: torch.Tensor, factor: int) -> torch.Tensor:
    """Zero-state interpolation of (B, L) rows -> (B, L*factor):
    y[n] = factor * sum_m x[m] h[n - m*factor], a transposed convolution."""
    length = xb.shape[-1]
    with fp32_convolutions():
        out = F.conv_transpose1d(xb[:, None, :], (h * factor)[None, None, :], stride=factor)
    return out[:, 0, : length * factor]


@spanned("stream.polyphase.interpolate")
def polyphase_interpolate(x: torch.Tensor, h: torch.Tensor, factor: int, block: int = 4096) -> torch.Tensor:
    """Upsample (..., T) by ``factor`` (zero-stuff + FIR), with gain
    ``factor`` so passband amplitude is preserved.

    y[n] = factor * sum_k h[k] * u[n-k], matching
    scipy.signal.upfirdn(h*factor, x, factor, 1)[:T*factor]: the mirror
    convention of :func:`polyphase_decimate`, so interpolate(f) followed
    by decimate(f) round-trips without a time shift. Long streams are
    framed into overlapped rows."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    taps = h.shape[-1]
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    xb = x.reshape(-1, t)
    b = xb.shape[0]
    if t <= 2 * block:
        return _interp_rows(xb, h, factor).reshape(*batch_shape, -1)
    halo = -(-(taps - 1) // factor)  # input samples of real left context
    frames = _frame_overlap(xb, block, halo)  # (B, nb, halo + block)
    nb = frames.shape[-2]
    y = _interp_rows(frames.reshape(b * nb, halo + block), h, factor)
    # Drop the halo's outputs: frame i's output j maps to global
    # i*block*factor + j - halo*factor.
    y = y.reshape(b, nb, (halo + block) * factor)[..., halo * factor :]
    y = y.reshape(b, nb * block * factor)[..., : t * factor]
    return y.reshape(*batch_shape, -1)
