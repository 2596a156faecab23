"""The wideband SDR receiver chain (PyTorch counterpart of
``chowdsp_fft_tpu/models/sdr.py``; BASELINE config 5):

    IQ stream (..., T) complex64
      -> polyphase decimation (one CUDA kernel on the card; strided float32
         convolutions elsewhere)
      -> polyphase FFT channelizer (complex FFT: K5 at C <= 256, K4 above)
      -> per-channel FM discriminator
      -> audio low-pass + decimate per channel

The three filters are buffers of the module (``front_lp``, ``audio_lp``,
``channelizer.hpoly``), so ``.to(device)`` moves them all.
:meth:`SDRChain.sharded_step` runs the chain over a mesh axis: the
wideband front half on time shards, one all_to_all, the per-channel back
half on channel shards.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..parallel.dist_fft import all_to_all
from ..parallel.mesh import TIME_AXIS, DeviceMesh, axis_group, local_shard, require_mesh_device, sharded
from ..parallel.sharded import halo_exchange_left
from ..stream import Channelizer, design_lowpass, fm_demod, polyphase_decimate
from ..utils.tracing import spanned

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

    @spanned("models.sdr.front_end")
    def front_end(self, iq: torch.Tensor) -> torch.Tensor:
        """Decimating anti-alias front end on the wideband stream; the I/Q
        planes go through one batched decimator call, read where they lie
        in the interleaved capture (a (..., 2, T) view)."""
        planes = torch.view_as_real(iq.resolve_conj()).movedim(-1, -2)
        dec = polyphase_decimate(planes, self.front_lp, self.config.decimation)
        return torch.complex(dec[..., 0, :], dec[..., 1, :])

    @spanned("models.sdr.back_end")
    def back_end(self, channels: torch.Tensor) -> torch.Tensor:
        """Per-channel FM demod + audio filtering. channels: (..., C, S)."""
        c = self.config
        audio = fm_demod(channels, gain=c.fm_gain)
        # Decimating filter: computes only the kept output samples.
        return polyphase_decimate(audio, self.audio_lp, c.audio_decimation)

    @spanned("models.sdr.forward")
    def forward(self, iq: torch.Tensor) -> torch.Tensor:
        """(..., T) complex IQ -> (..., C, T/(decim*C*audio_decim)) float32 audio."""
        return self.back_end(self.channelizer(self.front_end(iq)))

    # ------------------------------------------------------------------
    # Sharded application
    # ------------------------------------------------------------------

    def _shard_halo(self) -> tuple[int, int]:
        """(wideband halo, decimated samples dropped) of a time shard: the
        front FIR needs front_taps-1 input samples of history, rounded up to
        whole decimation steps (the shard's decimation phase stays aligned),
        and the channelizer the K-1 frames of C decimated samples before the
        shard (K = taps per branch). The front end's first ``dropped``
        outputs on the extended shard are its transient."""
        c = self.config
        dropped = -(-(c.front_taps - 1) // c.decimation)
        return (dropped + (c.channel_taps_per_branch - 1) * c.channels) * c.decimation, dropped

    def sharded_step(self, mesh: DeviceMesh, axis_name: str | None = None):
        """A function computing the chain with the wideband input (..., T)
        time-sharded over the mesh axis and the channelized back half
        channel-sharded; returns the (..., C, S) audio DTensor sharded over
        the channels (dim -2). The seam is written out (JAX leaves it to
        GSPMD): each rank takes :meth:`_shard_halo`'s wideband history from
        its left neighbour (one halo hop), runs the front end and the
        channelizer on its extended shard and keeps its own steps; one
        all_to_all turns the (C, S/D) time-sharded channel frames into
        (C/D, S) channel-sharded ones; ``back_end`` runs on whole channels.
        T must divide into D shards of whole channelizer frames
        (decimation * C wideband samples), C over D."""
        require_mesh_device(self.front_lp, mesh)
        names = mesh.mesh_dim_names
        axis = axis_name or (TIME_AXIS if TIME_AXIS in names else names[0])
        c = self.config
        halo, dropped = self._shard_halo()

        @spanned("models.sdr.sharded_step")
        def step(iq):
            group, d, _ = axis_group(mesh, axis)
            x = local_shard(iq, mesh, axis, -1)
            frame = c.decimation * c.channels
            if x.shape[-1] % frame or c.channels % d:
                raise ValueError(f"{x.shape[-1] * d} samples over {d} devices: each shard must hold whole "
                                 f"frames of {frame} samples, and {c.channels} channels must divide over them")
            ext = halo_exchange_left(x, halo, mesh, axis)
            ch = self.channelizer(self.front_end(ext)[..., dropped:])[..., c.channel_taps_per_branch - 1:]
            # (..., C, S/D) -> (..., C/D, S): block d of the channels goes to rank d.
            *lead, _, s_loc = ch.shape
            send = torch.view_as_real(ch.reshape(*lead, d, c.channels // d, s_loc).movedim(-3, 0).contiguous())
            recv = torch.view_as_complex(all_to_all(send, group))  # block i: steps of rank i
            own = recv.movedim(0, -2).reshape(*lead, c.channels // d, d * s_loc)
            return sharded(self.back_end(own), mesh, axis, -2)

        return step
