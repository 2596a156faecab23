"""``cpu_cell`` with two more planted faults, in the SDR chain: half of
the channels' audio zeroed where the chain produces it, and the
channelizer's branch taps stored oldest-first by its constructor.

    python -m portbench.tests.sdr_cpu_cell WORKLOAD SEED SECONDS [--control] [--fault NAME] [--trace]
"""

from __future__ import annotations

from chowdsp_fft_tpu_torch.models import SDRChain
from chowdsp_fft_tpu_torch.stream import Channelizer

from portbench.tests import cpu_cell


def _half_channels():
    forward = SDRChain.forward

    def half(self, iq):
        y = forward(self, iq).clone()
        y[..., y.shape[-2] // 2:, :] = 0
        return y

    SDRChain.forward = half


def _unflipped_branches():
    Channelizer.polyphase = staticmethod(lambda proto, channels: proto.reshape(-1, channels).T)


cpu_cell.FAULTS["half_channels"] = _half_channels
cpu_cell.FAULTS["unflipped_branches"] = _unflipped_branches

if __name__ == "__main__":
    cpu_cell.main()
