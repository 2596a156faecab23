"""The batched real round trip: ``api.rfft_packed`` then
``api.irfft_packed`` on (batch, N) rows, ordered packed planes."""

from __future__ import annotations

import torch

from chowdsp_fft_tpu_torch import api

from .. import roofline
from ..reference.compare import gap
from ..reference.precision import round_tf32
from ..reference.real_fft import rfft_packed


class Roundtrip:
    def __init__(self, config: dict, plan, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.config, self.plan = config, plan
        self.n, self.rows, self.engine = config["n"], plan["batch"], config["engine"]
        self.x = torch.randn(plan.ring, self.rows, self.n, generator=gen, device=device)
        self.samples_per_call = self.rows * self.n

    def call(self, i: int):
        re, im = api.rfft_packed(self.x[self.plan.slot(i)], engine=self.engine)
        return re, im, api.irfft_packed(re, im, engine=self.engine)

    def control(self, i: int):
        x = round_tf32(self.x[self.plan.slot(i)])
        re, im = rfft_packed(x)
        return re.float(), im.float(), x * self.n

    def release(self) -> None:
        pass

    def check(self, kept: dict) -> dict:
        spectrum, trip = {}, {}
        for i, (re, im, y) in sorted(kept.items()):
            x = self.x[self.plan.slot(i)]
            ref_re, ref_im = rfft_packed(x)
            spectrum[i] = gap(torch.stack([re, im]), torch.stack([ref_re, ref_im]))
            trip[i] = gap(y, x.double() * self.n)
        return {"spectrum_gap": spectrum, "roundtrip_gap": trip}

    def work(self) -> dict:
        return {"fft": roofline.roundtrip_work(self.n, self.rows)}

    def yardstick(self) -> str:
        """cuFFT's device time for the same round trip on the same card."""
        x = self.x[0]
        for _ in range(3):
            torch.fft.irfft(torch.fft.rfft(x), n=self.n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        calls = 50
        start.record()
        for _ in range(calls):
            torch.fft.irfft(torch.fft.rfft(x), n=self.n)
        end.record()
        end.synchronize()
        return (f"cufft_roundtrip_ms {start.elapsed_time(end) / calls:.6f} "
                f"(torch.fft.rfft + irfft on {self.rows} x {self.n}, CUDA events over {calls} calls)")


ENTRIES = {"roundtrip": Roundtrip}
