"""Polyphase FFT channelizer, a critically sampled analysis filter bank
(PyTorch counterpart of ``chowdsp_fft_tpu/stream/channelizer.py``).

Splits a wideband stream into C uniformly spaced baseband channels, each
decimated by C:

  1. commutate the stream into C polyphase branches;
  2. FIR each branch with the matching polyphase component of a prototype
     low-pass (one grouped ``conv1d``, full float32);
  3. an unscaled inverse DFT across the branch axis per output step, on
     the port's complex FFT engine (``api.ifft``: the small-N FFT K5 at
     C <= 256, the complex Stockham kernel K4 at C = n1*128 above),
     then the 1/C gain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import api
from ..utils.tracing import span, spanned
from .polyphase import design_lowpass, fp32_convolutions

__all__ = ["Channelizer", "channelize"]


class Channelizer(nn.Module):
    """C-channel critically-sampled polyphase channelizer.

    Args:
      channels: number of channels C (must be a supported FFT size).
      taps_per_branch: prototype filter length is C * taps_per_branch.
      engine: FFT engine selector passed through to the api layer.
      device: where the polyphase taps (buffer ``hpoly``) live; the card
        unless told otherwise.
    """

    def __init__(self, channels: int, taps_per_branch: int = 8, engine: str = "auto",
                 device: torch.device | str = "cuda"):
        super().__init__()
        if not api.is_valid_size(channels, api.FFT_COMPLEX):
            raise api.InvalidSizeError(f"channel count {channels} unsupported")
        self.channels = channels
        self.taps_per_branch = taps_per_branch
        self.engine = engine
        proto = design_lowpass(channels * taps_per_branch, 1.0 / channels, device=device)
        self.register_buffer("hpoly", self.polyphase(proto, channels))
        self.plan = api.cached_plan(channels, api.FFT_COMPLEX)

    @staticmethod
    def polyphase(proto: torch.Tensor, channels: int) -> torch.Tensor:
        """(C * K,) prototype in natural order -> the (C, K) branch taps
        that ``hpoly`` holds: branch p gets proto[p::C], newest-first."""
        return torch.flip(proto.reshape(-1, channels).T, (-1,))

    @spanned("stream.channelizer.forward")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., T) real or complex wideband -> (..., C, T//C) complex64
        channel streams (channel c centered at f = c/C of the input rate)."""
        c, k = self.channels, self.taps_per_branch
        steps = x.shape[-1] // c
        x = x[..., : steps * c]
        batch_shape = x.shape[:-1]

        # Branch p at step m sees x[m*C + (C-1-p) - k'*C]: the commutator
        # runs backwards through each block. (steps, C) frames, flipped,
        # then FIR along steps with the (C, K) polyphase taps.
        with span("stream.channelizer.commutate"):
            branches = torch.flip(x.reshape(*batch_shape, steps, c), (-1,)).transpose(-1, -2)
            parts = (branches.real, branches.imag) if x.is_complex() else (branches,)
            xb = torch.stack([p.to(torch.float32) for p in parts]).reshape(-1, c, steps)
            xb = F.pad(xb, (k - 1, 0))
        # hpoly is stored newest-first: conv1d computes a correlation, so
        # the effective branch filter is hpoly reversed, i.e. proto[j*C + p]
        # as the filter bank requires. (A second flip here would
        # delay-reverse every branch, a bug the JAX package once had.)
        with span("stream.channelizer.branch_fir"):
            with fp32_convolutions():
                filt = F.conv1d(xb, self.hpoly[:, None, :], groups=c)
            filt = filt.reshape(len(parts), *batch_shape, c, steps)
            filt = torch.complex(filt[0], filt[1]) if x.is_complex() else filt[0].to(torch.complex64)

        # Inverse DFT across the branch axis for every step: batch = (..., steps).
        spec = api.ifft(filt.transpose(-1, -2), plan=self.plan, engine=self.engine)
        # The unscaled backward transform (synthesis phase rotation
        # convention); 1/C normalizes channel gain.
        return (spec * (1.0 / c)).transpose(-1, -2)


def channelize(x: torch.Tensor, channels: int, taps_per_branch: int = 8, engine: str = "auto") -> torch.Tensor:
    """One-shot :class:`Channelizer`; it follows ``x``'s device."""
    return Channelizer(channels, taps_per_branch, engine=engine, device=x.device)(x)
