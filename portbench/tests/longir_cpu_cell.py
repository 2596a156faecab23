"""``cpu_cell`` with two more planted faults, in the long-IR reverb: half
of the channels zeroed where ``fir_filter_ols`` produces them, and the
real composite's Hermitian assembly with its ``flip``s left out (the
conjugate half of the spectrum taken in the wrong order, both ways).

    python -m portbench.tests.longir_cpu_cell WORKLOAD SEED SECONDS [--control] [--fault NAME] [--trace]
"""

from __future__ import annotations

import torch

from chowdsp_fft_tpu_torch import stream
from chowdsp_fft_tpu_torch.ops import hopper_composite

from portbench.tests import cpu_cell


def _half_channels():
    fir_filter_ols = stream.fir_filter_ols

    def half(x, h, block=None, engine="auto"):
        y = fir_filter_ols(x, h, block=block, engine=engine).clone()
        y[y.shape[0] // 2:] = 0
        return y

    stream.fir_filter_ols = half


class _Unflipped:
    """``torch`` with a ``flip`` that returns its input as it is."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def flip(t, dims):
        return t


def _unflipped_hermitian():
    hopper_composite.torch = _Unflipped()


cpu_cell.FAULTS["half_channels"] = _half_channels
cpu_cell.FAULTS["unflipped_hermitian"] = _unflipped_hermitian

if __name__ == "__main__":
    cpu_cell.main()
