"""The wideband SDR receiver chain (PyTorch counterpart of
``chowdsp_fft_tpu/models/sdr.py``; BASELINE config 5):

    IQ stream (..., T) complex64
      -> polyphase decimation (float32 convolutions)
      -> polyphase FFT channelizer (complex FFT: K5 at C <= 256, K4 above)
      -> per-channel FM discriminator
      -> audio low-pass + decimate per channel

The three filters are buffers of the module (``front_lp``, ``audio_lp``,
``channelizer.hpoly``), so ``.to(device)`` moves them all. The JAX
chain's multi-chip ``sharded_step`` is not ported yet (it needs the
``parallel`` layer).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..stream import Channelizer, design_lowpass, fm_demod, polyphase_decimate

__all__ = ["SDRChainConfig", "SDRChain"]


@dataclasses.dataclass(frozen=True)
class SDRChainConfig:
    channels: int = 256  # channelizer bins
    decimation: int = 2  # front-end decimation factor
    front_taps: int = 64  # anti-alias FIR length
    channel_taps_per_branch: int = 8
    audio_decimation: int = 4  # per-channel audio decimation
    audio_taps: int = 64
    fm_gain: float = 1.0
    engine: str = "auto"


class SDRChain(nn.Module):
    """SDR receiver chain; call with complex IQ (..., T) on the module's
    device, the card unless ``device`` says otherwise (``device="cpu"``
    runs the kernels' plain versions)."""

    def __init__(self, config: SDRChainConfig = SDRChainConfig(), device: torch.device | str = "cuda"):
        super().__init__()
        self.config = c = config
        self.register_buffer("front_lp", design_lowpass(c.front_taps, 1.0 / c.decimation, device=device))
        self.register_buffer("audio_lp", design_lowpass(c.audio_taps, 1.0 / c.audio_decimation, device=device))
        self.channelizer = Channelizer(c.channels, c.channel_taps_per_branch, engine=c.engine, device=device)

    def front_end(self, iq: torch.Tensor) -> torch.Tensor:
        """Decimating anti-alias front end on the wideband stream; the I/Q
        planes go through one batched decimator call."""
        planes = torch.stack([iq.real, iq.imag], dim=-2)
        dec = polyphase_decimate(planes, self.front_lp, self.config.decimation)
        return torch.complex(dec[..., 0, :], dec[..., 1, :])

    def back_end(self, channels: torch.Tensor) -> torch.Tensor:
        """Per-channel FM demod + audio filtering. channels: (..., C, S)."""
        c = self.config
        audio = fm_demod(channels, gain=c.fm_gain)
        # Decimating filter: computes only the kept output samples.
        return polyphase_decimate(audio, self.audio_lp, c.audio_decimation)

    def forward(self, iq: torch.Tensor) -> torch.Tensor:
        """(..., T) complex IQ -> (..., C, T/(decim*C*audio_decim)) float32 audio."""
        return self.back_end(self.channelizer(self.front_end(iq)))
