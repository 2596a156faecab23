"""``stream.fir_filter_ols``: config 3's single-partition FIR filter on
whole clips, each channel by its own IR (the long-IR reverb). The IR
spectra are made inside every call, as the entry makes them; the control
and the check are the convolver's: the float64 linear convolution of the
same clip and IRs."""

from __future__ import annotations

import torch

from chowdsp_fft_tpu_torch import stream

from .. import longir_work
from . import convolver


class Apply(convolver.Apply):
    """Back-to-back ``fir_filter_ols`` calls on (channels, clip) clips
    from a ring."""

    def __init__(self, config: dict, plan, seed: int, device):
        marks = convolver._Marks(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.config, self.plan = config, plan
        self.samples = int(plan["clip_seconds"] * config["sample_rate"])
        self.ir = convolver._impulse_responses(config, gen, device)
        marks("the impulse responses")
        self.clips = torch.randn(plan.ring, config["channels"], self.samples, generator=gen, device=device)
        self.samples_per_call = config["channels"] * self.samples
        marks("the clips")
        self.setup_marks = marks.marks

    def call(self, i: int) -> torch.Tensor:
        return stream.fir_filter_ols(self.clips[self.plan.slot(i)], self.ir, block=self.config["block"],
                                     engine=self.config["engine"])

    def release(self) -> None:
        pass

    def work(self) -> dict:
        c = self.config
        shape = (c["channels"], self.samples, c["ir_taps"], c["block"])
        return {"longir": longir_work.call_work(*shape), "composite": longir_work.composite_work(*shape)}


ENTRIES = {"apply": Apply}
