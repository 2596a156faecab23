"""Demodulation stages for the SDR chain (PyTorch counterpart of
``chowdsp_fft_tpu/stream/demod.py``): the FM discriminator (one CUDA
kernel on the card, ``ops/demod.py``; torch ops on the CPU), elementwise
torch ops, and a log-depth scan for the DC blocker's recursion."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import demod
from ..ops.autodiff import FMDemod, needs_grad
from ..utils.tracing import spanned

__all__ = ["fm_demod", "am_demod", "dc_block"]


@spanned("stream.demod.fm")
def fm_demod(z: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Quadrature FM discriminator over complex baseband (..., T):
    y[n] = gain * angle(z[n] * conj(z[n-1])) via atan2, y[0] from zero
    phase history. Float32 out. On a CUDA tensor one kernel launch reads
    the rows where they lie and writes y[0] = 0
    (``ops.demod.fm_demod_kernel``; through ``autodiff.FMDemod`` where
    grad is needed); elsewhere torch ops, whose y[0] is atan2 of signed
    zeros (0 or +-gain*pi)."""
    z = torch.as_tensor(z).to(torch.complex64)
    if z.is_cuda and needs_grad(z):
        return FMDemod.apply(z, gain)
    return demod.fm_demod(z, gain)


def am_demod(z: torch.Tensor) -> torch.Tensor:
    """Envelope detector: |z| (AM demodulation before DC block)."""
    return torch.as_tensor(z).abs().to(torch.float32)


def dc_block(x: torch.Tensor, alpha: float = 0.995) -> torch.Tensor:
    """Single-pole DC blocker y[n] = x[n] - x[n-1] + alpha*y[n-1].

    The recursion y = a*y_prev + b composes associatively, pairs (a, b);
    a doubling (Hillis-Steele) scan folds in the element s places back at
    step s = 1, 2, 4, ..., so the whole stream takes log2(T) passes
    instead of T sequential steps."""
    x = torch.as_tensor(x, dtype=torch.float32)
    b = x - F.pad(x[..., :-1], (1, 0))
    a = torch.full_like(b, alpha)
    t = x.shape[-1]
    s = 1
    while s < t:
        # (a, b)[n] <- (a, b)[n-s] then (a, b)[n]: a = a'a, b = a*b' + b
        b = torch.cat([b[..., :s], b[..., s:] + a[..., s:] * b[..., :-s]], dim=-1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return b
