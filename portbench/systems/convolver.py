"""``MultichannelConvolver``: offline ``apply`` on whole clips."""

from __future__ import annotations

import time

import torch

from chowdsp_fft_tpu_torch.models import ConvolverConfig, MultichannelConvolver

from .. import roofline
from ..reference import convolution
from ..reference.compare import gap
from ..reference.precision import round_tf32


def _impulse_responses(config: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Seeded decaying noise, one IR a channel (as the reverb example)."""
    taps = config["ir_taps"]
    noise = torch.randn(config["channels"], taps, generator=gen, device=device)
    decay = torch.exp(-torch.linspace(0.0, config["ir_decay"], taps, device=device))
    return noise * decay * config["ir_scale"]


def _convolver(config: dict, ir: torch.Tensor, device) -> MultichannelConvolver:
    cfg = ConvolverConfig(channels=config["channels"], sample_rate=config["sample_rate"],
                          block=config["block"], engine=config["engine"])
    return MultichannelConvolver(ir, cfg, device=device)


class _Marks:
    """Seconds of each stage of set-up, each ended by a synchronise."""

    def __init__(self, device):
        self.sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        self.last, self.marks = time.perf_counter(), []

    def __call__(self, label: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.marks.append((label, now - self.last))
        self.last = now


class Apply:
    """Back-to-back ``apply`` calls on (channels, clip) clips from a ring."""

    def __init__(self, config: dict, plan, seed: int, device):
        marks = _Marks(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.config, self.plan = config, plan
        self.samples = int(plan["clip_seconds"] * config["sample_rate"])
        self.ir = _impulse_responses(config, gen, device)
        marks("the impulse responses")
        self.clips = torch.randn(plan.ring, config["channels"], self.samples, generator=gen, device=device)
        self.samples_per_call = config["channels"] * self.samples
        marks("the clips")
        self.conv = _convolver(config, self.ir, device)
        marks("the convolver (its IR spectra)")
        self.setup_marks = marks.marks

    def call(self, i: int) -> torch.Tensor:
        return self.conv.apply(self.clips[self.plan.slot(i)])

    def control(self, i: int) -> torch.Tensor:
        x = self.clips[self.plan.slot(i)]
        return convolution.linear(round_tf32(x), round_tf32(self.ir)).float()

    def release(self) -> None:
        self.conv = None

    def check(self, kept: dict) -> dict:
        refs, gaps = {}, {}
        for i, y in sorted(kept.items()):
            slot = self.plan.slot(i)
            if slot not in refs:
                refs[slot] = convolution.linear(self.clips[slot], self.ir)
            gaps[i] = gap(y, refs[slot])
        return {"output_gap": gaps}

    def work(self) -> dict:
        c = self.config
        return {"call": roofline.partitioned_convolution_work(c["channels"], self.samples, c["ir_taps"], c["block"])}


ENTRIES = {"apply": Apply}
