"""The long-IR reverb's path on the CPU: ``stream.fir_filter_ols`` on the
real two-level composite (N = 2^18 here, 2^19 in the benchmark's cell
``longir64.offline``) against the benchmark's float64 reference
(``portbench.reference.convolution.linear``), within the cell's
``output_gap``. The same call on TF32-rounded inputs, and the composite's
Hermitian assembly without its flips, each fail that limit."""

import json
import pathlib

import pytest
import torch

from chowdsp_fft_tpu_torch import stream
from chowdsp_fft_tpu_torch.ops import hopper_composite
from portbench.reference import compare, convolution
from portbench.reference.precision import round_tf32

REPO = pathlib.Path(__file__).resolve().parents[1]
LIMIT = json.loads((REPO / "portbench" / "configs" / "longir64.json").read_text())["limits"]["output_gap"]
CHANNELS, T, TAPS = 2, 48_000, 40_000  # fir_filter_ols's default block gives N = 2^18


@pytest.fixture(scope="module")
def case():
    """Seeded audio and decaying-noise IRs (as the benchmark makes them),
    and their float64 linear convolution."""
    gen = torch.Generator().manual_seed(22)
    x = torch.randn(CHANNELS, T, generator=gen)
    h = torch.randn(CHANNELS, TAPS, generator=gen) * torch.exp(-torch.linspace(0.0, 8.0, TAPS)) * 0.01
    return x, h, convolution.linear(x, h)


class _Unflipped:
    """``torch`` with a ``flip`` that returns its input as it is."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def flip(t, dims):
        return t


def _counted(monkeypatch, name: str, calls: list):
    fn = getattr(hopper_composite, name)

    def run(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(hopper_composite, name, run)


@pytest.mark.parametrize("variant", ["program", "tf32_inputs", "unflipped_hermitian"])
def test_fir_filter_ols_on_the_composite_against_float64(case, monkeypatch, variant):
    x, h, ref = case
    calls = []
    _counted(monkeypatch, "rfft_composite", calls)
    _counted(monkeypatch, "irfft_composite", calls)
    if variant == "tf32_inputs":
        x, h = round_tf32(x), round_tf32(h)
    if variant == "unflipped_hermitian":
        monkeypatch.setattr(hopper_composite, "torch", _Unflipped())
    y = stream.fir_filter_ols(x, h)
    # the IRs' and the frames' forward transforms, one inverse
    assert sorted(calls) == ["irfft_composite", "rfft_composite", "rfft_composite"]
    assert y.shape == (CHANNELS, T)
    gap = compare.gap(y, ref)
    if variant == "program":
        assert gap <= LIMIT, gap
    else:
        assert not gap <= LIMIT, gap
