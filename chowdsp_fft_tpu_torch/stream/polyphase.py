"""Polyphase FIR decimation / interpolation (PyTorch counterpart of
``chowdsp_fft_tpu/stream/polyphase.py``).

Part of the SDR receiver chain (BASELINE config 5). Decimation on a CUDA
tensor is one hand-written kernel (``ops/polyphase.py``,
``csrc/polyphase.cu``) that reads the stream where it lies; on the CPU
it is the plain version, a strided ``torch.nn.functional.conv1d`` on
overlapped frames. Interpolation is ``conv_transpose1d`` (the JAX package
leaves both to ``lax.conv_general_dilated``, outside any Pallas kernel).
On a CUDA tensor that runs through cuDNN, which takes float32
convolutions through TF32 by default (~1e-3 relative error, the analog of
the TPU's bf16 default the JAX package overrides with
``Precision.HIGHEST``); every convolution here runs under
:func:`fp32_convolutions`, which turns TF32 off for its own duration only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.autodiff import PolyphaseDecimate, needs_grad
from ..ops.polyphase import decimate, fp32_convolutions
from ..utils.tracing import spanned
from .ols import _frame_overlap

__all__ = ["polyphase_decimate", "polyphase_interpolate", "design_lowpass", "fp32_convolutions"]


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


@spanned("stream.polyphase.decimate")
def polyphase_decimate(x: torch.Tensor, h: torch.Tensor, factor: int, block: int = 4096) -> torch.Tensor:
    """Decimate (..., T) by ``factor`` after FIR anti-alias filtering.

    Equivalent to scipy.signal.upfirdn(h, x, 1, factor) restricted to the
    first T//factor outputs (zero initial state). On a CUDA tensor one
    kernel launch filters and decimates every row where it lies
    (``ops.polyphase.decimate_kernel``; through
    ``autodiff.PolyphaseDecimate`` where grad is needed). Elsewhere long
    streams are framed into overlapped ``block``-sample rows, so the
    convolution runs with a large batch dimension."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    batch_shape = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    if xb.is_cuda and needs_grad(xb, h):
        y = PolyphaseDecimate.apply(xb, h, factor)
    else:
        y = decimate(xb, h, factor, block)
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
