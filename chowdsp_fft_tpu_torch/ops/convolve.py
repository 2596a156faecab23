"""Frequency-domain convolution helpers (counterpart of
``chowdsp_fft_tpu/ops/convolve.py``).

- ``convolve_accumulate``: ab + a * b * scaling on spectra;
- ``convolve_accumulate_packed``: the same on packed planes, with the
  DC·DC / Nyq·Nyq bin-0 patch-up;
- ``accumulate``: a + b.
"""

from __future__ import annotations

import torch

from ..utils.tracing import spanned

__all__ = [
    "convolve_accumulate",
    "convolve_accumulate_packed",
    "multiply_spectra",
    "accumulate",
]


def _is_unit(scaling) -> bool:
    return isinstance(scaling, (int, float)) and scaling == 1.0


def _scale(scaling, device):
    """A number stays a Python float (no host-to-device copy per call); a
    tensor becomes float32 on ``device``."""
    if isinstance(scaling, torch.Tensor):
        return scaling.to(dtype=torch.float32, device=device)
    return float(scaling)


@spanned("ops.convolve.accumulate_packed")
def convolve_accumulate_packed(
    a: tuple[torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor],
    ab: tuple[torch.Tensor, torch.Tensor] | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ab += a * b * scaling`` on packed real-spectrum planes.

    Bin 0 packs two purely-real bins (DC in re[0], Nyquist in im[0]), so
    the product there is two real products. Valid in ordered and unordered
    bin order alike: bin 0 is index 0 in both."""
    a_re, a_im = a
    b_re, b_im = b
    pr = a_re * b_re - a_im * b_im
    pi = a_re * b_im + a_im * b_re
    pr = torch.cat([a_re[..., :1] * b_re[..., :1], pr[..., 1:]], dim=-1)  # DC * DC
    pi = torch.cat([a_im[..., :1] * b_im[..., :1], pi[..., 1:]], dim=-1)  # Nyq * Nyq
    if not _is_unit(scaling):
        s = _scale(scaling, pr.device)
        pr, pi = pr * s, pi * s
    if ab is None:
        return pr, pi
    return ab[0] + pr, ab[1] + pi


def convolve_accumulate(
    a: torch.Tensor,
    b: torch.Tensor,
    ab: torch.Tensor | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """Return ``ab + a * b * scaling`` over frequency-domain tensors
    (ordered or unordered: the op is order-independent)."""
    prod = a * b
    if not _is_unit(scaling):
        prod = prod * _scale(scaling, prod.device)
    if ab is None:
        return prod
    return ab + prod


def multiply_spectra(a: torch.Tensor, b: torch.Tensor, scaling: float | torch.Tensor = 1.0) -> torch.Tensor:
    """Scaled spectral product (convolve_accumulate with zero accumulator)."""
    return convolve_accumulate(a, b, ab=None, scaling=scaling)


def accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of two signals."""
    return a + b
