"""The batched complex round trip: ``api.fft`` then ``api.ifft`` on
(batch, N) complex64 rows, natural order, unscaled both ways (the
backward transform of the spectrum is N x)."""

from __future__ import annotations

import torch

from chowdsp_fft_tpu_torch import api

from .. import cfft_work
from ..reference import complex_fft
from ..reference.compare import gap
from ..reference.precision import round_tf32
from . import roundtrip


def _gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """``compare.gap`` over the real and imaginary parts as components."""
    return gap(torch.view_as_real(out), torch.view_as_real(ref))


class ComplexRoundtrip(roundtrip.Roundtrip):
    """``roundtrip.Roundtrip`` on complex rows: its constructor's ring in
    complex64, and the complex entries, reference and cuFFT calls."""

    def __init__(self, config: dict, plan, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.config, self.plan = config, plan
        self.n, self.rows, self.engine = config["n"], plan["batch"], config["engine"]
        # Unit variance: real and imaginary parts of variance 1/2 each.
        self.x = torch.randn(plan.ring, self.rows, self.n, dtype=torch.complex64, generator=gen, device=device)
        self.samples_per_call = self.rows * self.n

    def call(self, i: int):
        spec = api.fft(self.x[self.plan.slot(i)], engine=self.engine)
        return spec, api.ifft(spec, engine=self.engine)

    def control(self, i: int):
        x = self.x[self.plan.slot(i)]
        x = torch.complex(round_tf32(x.real), round_tf32(x.imag))
        return complex_fft.fft(x).to(torch.complex64), x * self.n

    def check(self, kept: dict) -> dict:
        spectrum, trip = {}, {}
        for i, (spec, y) in sorted(kept.items()):
            x = self.x[self.plan.slot(i)]
            spectrum[i] = _gap(spec, complex_fft.fft(x))
            trip[i] = _gap(y, x.to(torch.complex128) * self.n)
        return {"spectrum_gap": spectrum, "roundtrip_gap": trip}

    def work(self) -> dict:
        return {"cfft": cfft_work.roundtrip_work(self.n, self.rows)}

    def yardstick(self) -> str:
        """cuFFT's device time for the same round trip on the same card,
        unscaled both ways as the program's."""
        x = self.x[0]
        for _ in range(3):
            torch.fft.ifft(torch.fft.fft(x), norm="forward")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        calls = 50
        start.record()
        for _ in range(calls):
            torch.fft.ifft(torch.fft.fft(x), norm="forward")
        end.record()
        end.synchronize()
        return (f"cufft_roundtrip_ms {start.elapsed_time(end) / calls:.6f} "
                f"(torch.fft.fft + ifft on {self.rows} x {self.n} complex64, CUDA events over {calls} calls)")


ENTRIES = {"roundtrip": ComplexRoundtrip}
