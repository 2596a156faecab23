"""Multichannel partitioned convolution (PyTorch counterpart of
``chowdsp_fft_tpu/models/convolver.py``; BASELINE config 4: 64 channels
x 10 s at 48 kHz through long per-channel impulse responses).

Each channel is filtered by its own impulse response through the
uniformly partitioned overlap-save FDL (``stream.PartitionedFIR``): the
offline form transforms every block of every channel in one batched K1
call, accumulates the P partitions with the packed convolve-accumulate
and inverts in one batched K2 call. The IR bank's packed spectra are
buffers of the module, so ``.to(device)`` moves them.

Two sharded forms (``parallel/``): :meth:`~MultichannelConvolver.channel_sharded_apply`
gives each rank whole channels (no communication), and
:meth:`~MultichannelConvolver.time_sharded_apply` a time shard of every
channel, with one (taps-1)-sample halo hop an application.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..parallel.mesh import CHANNEL_AXIS, DeviceMesh, axis_group, local_shard, require_mesh_device, sharded
from ..parallel.sharded import _sharded_stream_filter
from ..stream import PartitionedFIR
from ..utils.tracing import spanned

__all__ = ["ConvolverConfig", "MultichannelConvolver"]


@dataclasses.dataclass(frozen=True)
class ConvolverConfig:
    channels: int = 64
    sample_rate: int = 48000
    block: int = 1024  # FDL partition size (FFT size = 2*block)
    engine: str = "auto"


class MultichannelConvolver(nn.Module):
    """Streaming convolver: per-channel impulse responses, one FDL shape.

    ``ir`` is (channels, taps), one impulse response per channel, or
    (taps,), broadcast to every channel. The module lives on ``device``,
    the card unless told otherwise (``device="cpu"`` runs the kernels'
    plain versions). Offline: :meth:`apply` (also ``forward``) filters
    whole (channels, T) streams. Streaming: :meth:`init_state` and
    :meth:`step` process one (channels, block) frame at a time.
    """

    def __init__(self, ir, config: ConvolverConfig = ConvolverConfig(),
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.config = config
        ir = torch.as_tensor(ir, dtype=torch.float32).to(device)
        if ir.ndim == 1:
            ir = ir.expand(config.channels, ir.shape[-1])
        if ir.shape[0] != config.channels:
            raise ValueError(f"ir has {ir.shape[0]} channels, config says {config.channels}")
        fir = PartitionedFIR(ir, block=config.block, engine=config.engine)
        self.taps = ir.shape[-1]
        self.register_buffer("h_re", fir.h_re)
        self.register_buffer("h_im", fir.h_im)

    @classmethod
    def from_spectra(cls, h_re: torch.Tensor, h_im: torch.Tensor,
                     config: ConvolverConfig = ConvolverConfig()) -> "MultichannelConvolver":
        """Build from (channels, P, block) packed IR spectra already in the
        engine's unordered layout (see ``convert.convolver_from_numpy``)."""
        fir = PartitionedFIR.from_spectra(h_re, h_im, config.block, config.engine)
        if fir.h_re.ndim != 3 or fir.h_re.shape[0] != config.channels:
            raise ValueError(f"spectra {tuple(h_re.shape)} are not (channels={config.channels}, P, block)")
        conv = cls.__new__(cls)
        nn.Module.__init__(conv)
        conv.config = config
        conv.taps = fir.partitions * config.block  # the spectra's length; trailing taps may be zero
        conv.register_buffer("h_re", fir.h_re)
        conv.register_buffer("h_im", fir.h_im)
        return conv

    @property
    def fir(self) -> PartitionedFIR:
        """The FDL on the module's current spectra."""
        return PartitionedFIR._on_spectra(self.h_re, self.h_im, self.config.block, self.config.engine)

    # -- offline -----------------------------------------------------------

    @spanned("models.convolver.apply")
    def apply(self, x) -> torch.Tensor:
        """Filter (channels, T) streams -> (channels, T): the batched
        offline FDL on the IR bank's partitions."""
        return self.fir.apply_offline(x)

    def forward(self, x) -> torch.Tensor:
        return self.apply(x)

    # -- streaming -----------------------------------------------------------

    def init_state(self) -> dict:
        return self.fir.init_state((self.config.channels,))

    @spanned("models.convolver.step")
    def step(self, state: dict, frame) -> tuple[dict, torch.Tensor]:
        """One (channels, block) frame in -> one (channels, block) out."""
        return self.fir.step(state, frame)

    # -- sharded ---------------------------------------------------------------

    def channel_sharded_apply(self, mesh: DeviceMesh, axis_name: str = CHANNEL_AXIS):
        """Channels sharded over the mesh axis: each rank filters its own
        channels with their own IR spectra; no communication. Returns a
        function (channels, T) -> (channels, T) DTensor sharded along dim 0
        (its input a DTensor sharded so, or a tensor every rank holds
        whole). The module must lie on the mesh's device type."""
        require_mesh_device(self.h_re, mesh)

        def run(x):
            _, size, index = axis_group(mesh, axis_name)
            if self.config.channels % size:
                raise ValueError(f"{self.config.channels} channels do not divide over {size} devices")
            per = self.config.channels // size
            xl = local_shard(x, mesh, axis_name, 0)
            own = slice(index * per, (index + 1) * per)
            fir = PartitionedFIR._on_spectra(self.h_re[own], self.h_im[own], self.config.block, self.config.engine)
            return sharded(fir.apply_offline(xl), mesh, axis_name, 0)

        return run

    def time_sharded_apply(self, mesh: DeviceMesh, axis_name: str):
        """The time axis sharded over the mesh axis: every rank filters its
        time shard of all channels, with the halo hop and boundary
        correction of ``parallel.sharded_partitioned_fir`` (taps-1
        samples). Returns a function (channels, T) -> (channels, T) DTensor
        sharded along the last dim."""
        require_mesh_device(self.h_re, mesh)
        return lambda x: _sharded_stream_filter(self.apply, x, mesh, axis_name, halo=self.taps - 1)
