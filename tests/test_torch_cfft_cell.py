"""The complex round trip's path on the CPU: ``api.fft`` then
``api.ifft`` on the complex two-level composite (N = 2^15, 256 x 128,
and 49152, 256 x 192, here; 2^20, 1024 x 1024, in the benchmark's cell
``cfft1048576.b64``) against the benchmark's float64 reference
(``portbench.reference.complex_fft``), within the cell's limits. The
same call on TF32-rounded inputs, and with the CPU stand-in's planted
faults (``portbench.tests.cfft_cpu_cell``: level 2 given the conjugate
twiddle, one row of the spectrum zeroed), each fails them. And the
cell's work, against numbers worked out by hand."""

import json
import pathlib

import pytest
import torch

from chowdsp_fft_tpu_torch import api
from chowdsp_fft_tpu_torch.ops import hopper_composite, tables
from portbench import cfft_work, roofline
from portbench.reference import compare, complex_fft
from portbench.reference.precision import round_tf32
from portbench.tests import cfft_cpu_cell

REPO = pathlib.Path(__file__).resolve().parents[1]
LIMITS = json.loads((REPO / "portbench" / "configs" / "cfft1048576.json").read_text())["limits"]


def _gap(out, ref):
    return compare.gap(torch.view_as_real(out), torch.view_as_real(ref))


def _counted(monkeypatch, calls: list):
    fn = hopper_composite.cfft_composite

    def run(x, plan, forward=True):
        calls.append("forward" if forward else "backward")
        return fn(x, plan, forward)

    monkeypatch.setattr(hopper_composite, "cfft_composite", run)


@pytest.mark.parametrize("variant", ["program", "tf32_inputs", "conjugate_twiddle", "zeroed_row"])
@pytest.mark.parametrize("n, rows, split", [(1 << 15, 3, (256, 128)), (49152, 2, (256, 192))])
def test_complex_roundtrip_against_float64(monkeypatch, n, rows, split, variant):
    gen = torch.Generator().manual_seed(n + rows)
    x = torch.randn(rows, n, dtype=torch.complex64, generator=gen)
    spec_ref, trip_ref = complex_fft.fft(x), x.to(torch.complex128) * n
    assert tables.split_large(n) == split
    calls = []
    _counted(monkeypatch, calls)
    if variant == "tf32_inputs":
        x = torch.complex(round_tf32(x.real), round_tf32(x.imag))
    if variant == "conjugate_twiddle":
        cfft_cpu_cell.conjugated_twiddle(monkeypatch.setattr)
    if variant == "zeroed_row":
        cfft_cpu_cell.zeroed_row(monkeypatch.setattr)
    spec = api.fft(x, engine="auto")
    y = api.ifft(spec, engine="auto")
    assert calls == ["forward", "backward"]
    assert spec.dtype == y.dtype == torch.complex64 and spec.shape == y.shape == (rows, n)
    gaps = {"spectrum_gap": _gap(spec, spec_ref), "roundtrip_gap": _gap(y, trip_ref)}
    if variant == "program":
        assert all(gaps[k] <= LIMITS[k] for k in LIMITS), gaps
    else:
        assert any(not gaps[k] <= LIMITS[k] for k in LIMITS), gaps


def test_reference_is_unscaled_and_natural_order():
    """Bin k of a complex tone at k0 is N where k = k0 and 0 elsewhere, and
    the unscaled backward of the reference's spectrum is N x."""
    n, k0 = 64, 5
    x = torch.exp(2j * torch.pi * k0 * torch.arange(n, dtype=torch.float64) / n)
    spec = complex_fft.fft(x)
    assert spec.dtype == torch.complex128
    assert torch.allclose(spec, n * torch.nn.functional.one_hot(torch.tensor(k0), n).to(spec.dtype), atol=1e-9)
    assert torch.allclose(torch.fft.ifft(spec, norm="forward"), n * x, atol=1e-9)


def test_the_calls_work():
    """At N = 2^20 and 64 rows: 2,147,483,648 bytes and 13,421,772,800
    operations, a least time of 0.6410 ms, set by the bytes."""
    bytes_moved, flops = cfft_work.roundtrip_work(1 << 20, 64)
    assert bytes_moved == 2_147_483_648 and flops == 13_421_772_800
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(6.410e-4, rel=1e-4)
    assert bytes_moved / roofline.HBM_BYTES_PER_S > flops / roofline.FP32_FLOPS
