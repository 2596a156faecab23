"""``SDRChain``: the wideband FM receiver on whole captures.

Each capture holds an FM carrier at the centre of every occupied channel
(``config["occupied"]``), each with its own message, a sum of tones, and
its own start phase, over complex noise; it is made on the device from
the seed. The captures' rate is the channel raster times D C, so the
chain's channels fall on the raster.

``check`` compares the audio of the occupied channels with the float64
reference (``reference/sdr.py``) on the same capture, with the filters
designed there from their definition, never read from the chain. Set-up
runs the reference's front end, filter bank and discriminator on every
capture, for the guard on the discriminator's steps; the audio of a
capture is computed in ``check``, for the kept calls alone. It skips the
channels the front end does not pass (noise alone, whose angle is
rounding) and, in each channel, the audio samples that read the
zero-state start-up: the channel steps before the branch filters and the
front end are full, and the step after them, whose discriminator reads
the last of them. There |z| is still a small share of its steady level
and the angle amplifies rounding; the program's step 0 is the angle of
two signed zeros, which may read +-pi.
"""

from __future__ import annotations

import math

import torch

from chowdsp_fft_tpu_torch.models import SDRChain, SDRChainConfig

from .. import sdr_work
from ..reference import sdr as reference
from ..reference.compare import gap
from ..reference.precision import round_tf32
from .convolver import _Marks

GUARD = math.pi - 0.5  # the largest discriminator step the captures may need
SAMPLES_PER_BLOCK = 1 << 16  # capture samples made at a time


def chain_config(config: dict) -> SDRChainConfig:
    return SDRChainConfig(channels=config["channels"], decimation=config["decimation"],
                          front_taps=config["front_taps"], channel_taps_per_branch=config["channel_taps_per_branch"],
                          audio_decimation=config["audio_decimation"], audio_taps=config["audio_taps"],
                          fm_gain=config["fm_gain"], engine=config["engine"])


def centre_turns(channels: int, decimation: int) -> torch.Tensor:
    """Each channel's centre in cycles a capture sample: c / (D C) for
    c < C / 2, else (c - C) / (D C)."""
    c = torch.arange(channels, dtype=torch.float64)
    return torch.where(c < channels // 2, c, c - channels) / (channels * decimation)


def occupied_channels(front_lp: torch.Tensor, channels: int, decimation: int, points: int = 65) -> list[int]:
    """The channels over whose whole band (centre +- half the raster) the
    front-end filter's gain stays within 1 dB of its gain at DC."""
    h = front_lp.detach().to("cpu", torch.float64)
    half = 0.5 / (channels * decimation)
    f = centre_turns(channels, decimation)[:, None] + torch.linspace(-half, half, points, dtype=torch.float64)
    k = torch.arange(h.shape[-1], dtype=torch.float64)
    response = (h * torch.polar(torch.ones_like(k), -2 * math.pi * f[..., None] * k)).sum(-1).abs()
    db = 20 * torch.log10(response / h.sum().abs())
    return [int(c) for c in torch.nonzero((db.abs() <= 1.0).all(-1)).flatten()]


def clean_step(config: dict) -> int:
    """The first discriminator sample whose inputs all come after the
    start-up: channel steps are full from K - 1 + ceil(ceil((front taps -
    1) / D) / C), and the discriminator reads the step before."""
    fill = -(-(config["front_taps"] - 1) // config["decimation"])
    return config["channel_taps_per_branch"] - 1 + -(-fill // config["channels"]) + 1


def clean_audio_start(config: dict) -> int:
    """The first audio sample that reads no discriminator sample before
    :func:`clean_step`: sample j reads j A - (audio taps - 1) .. j A."""
    return -(-(clean_step(config) + config["audio_taps"] - 1) // config["audio_decimation"])


def make_captures(config: dict, ring: int, samples: int, gen: torch.Generator, device) -> torch.Tensor:
    """(ring, samples) complex64 captures: an FM carrier at the centre of
    each occupied channel, over complex noise."""
    channels, decimation = config["channels"], config["decimation"]
    rate = float(config["raster_hz"] * channels * decimation)
    occupied = torch.tensor(config["occupied"], dtype=torch.int64, device=device)
    lo, hi = config["tone_hz"]
    shape = (ring, len(config["occupied"]), config["tones"])
    tone_hz = lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    amplitude = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    amplitude = amplitude / amplitude.sum(-1, keepdim=True)  # peak deviation at most deviation_hz
    tone_turns = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    start_turns = torch.rand(shape[:2], generator=gen, device=device, dtype=torch.float64)
    # The phase of a tone's term: the integral of deviation * amplitude * cos.
    index = config["deviation_hz"] * amplitude / tone_hz
    step = tone_hz / rate
    offset = torch.where(occupied < channels // 2, occupied, occupied - channels)
    period = channels * decimation  # a centre's phase repeats every D C samples
    out = torch.empty(ring, samples, dtype=torch.complex64, device=device)
    scale = 1.0 / math.sqrt(len(config["occupied"]))
    for r in range(ring):
        for s0 in range(0, samples, SAMPLES_PER_BLOCK):
            n = torch.arange(s0, min(samples, s0 + SAMPLES_PER_BLOCK), device=device)
            centre = ((offset[:, None] * n) % period).to(torch.float64) / period
            tones = torch.frac(step[r, ..., None] * n.to(torch.float64) + tone_turns[r, ..., None])
            message = (index[r, ..., None] * torch.sin(2 * math.pi * tones)).sum(-2)
            phase = 2 * math.pi * (centre + start_turns[r, :, None]) + message
            out[r, s0:s0 + n.shape[0]] = torch.complex(torch.cos(phase).sum(0), torch.sin(phase).sum(0)) * scale
    noise = torch.randn(2, ring, samples, generator=gen, device=device)
    return out + config["noise"] * torch.complex(noise[0], noise[1])


def _round_planes(z: torch.Tensor) -> torch.Tensor:
    """Complex ``z`` with its real and imaginary planes rounded to TF32."""
    return torch.complex(round_tf32(z.real), round_tf32(z.imag))


class Chain:
    """Back-to-back ``SDRChain`` calls on whole captures from a ring."""

    def __init__(self, config: dict, plan, seed: int, device):
        marks = _Marks(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.config, self.plan = config, plan
        self.samples_per_call = int(plan["capture_samples"])
        self.chain = SDRChain(chain_config(config), device=device)
        c = self.chain.config
        self.front_lp, self.audio_lp, self.proto = reference.filters(
            c.channels, c.decimation, c.front_taps, c.channel_taps_per_branch, c.audio_decimation, c.audio_taps,
            device)
        self.occupied = torch.tensor(config["occupied"], device=device)
        self.skip = clean_audio_start(config)
        marks("the chain and the reference's filters")
        self.captures = make_captures(config, plan.ring, self.samples_per_call, gen, device)
        marks("the captures")
        for slot in range(plan.ring):
            streams = reference.channel_streams(self.captures[slot], self.front_lp, self.proto, c.channels,
                                                c.decimation)
            steps = reference.discriminate(streams[self.occupied])[..., clean_step(config):]
            worst = float(steps.abs().max())
            if not worst <= GUARD:
                raise RuntimeError(f"capture {slot}: the reference's largest discriminator step on the occupied "
                                   f"channels is {worst:.4f} rad, over pi - 0.5: the comparison could straddle "
                                   f"the branch cut")
            del streams, steps
        marks("the reference's guard on every capture")
        self.setup_marks = marks.marks

    def call(self, i: int) -> torch.Tensor:
        return self.chain(self.captures[self.plan.slot(i)])

    def control(self, i: int) -> torch.Tensor:
        """The reference computed as a TF32 path would take it: the
        operands of each of its convolutions rounded to TF32, as cuDNN
        takes them with TF32 on (the capture's planes and the front end's
        taps; the decimated planes and the prototype; the discriminator's
        output and the audio taps), the rest in float64."""
        c = self.chain.config
        front_lp, audio_lp, proto = (round_tf32(h) for h in (self.front_lp, self.audio_lp, self.proto))
        front = reference.decimate(_round_planes(self.captures[self.plan.slot(i)]), front_lp, c.decimation)
        streams = reference.channelize(_round_planes(front), proto, c.channels)
        demod = round_tf32(reference.discriminate(streams, c.fm_gain))
        return reference.decimate(demod, audio_lp, c.audio_decimation).float()

    def release(self) -> None:
        self.chain = None

    def check(self, kept: dict) -> dict:
        c, gaps, refs = self.config, {}, {}
        for i, y in sorted(kept.items()):
            slot = self.plan.slot(i)
            if slot not in refs:
                refs[slot] = reference.chain(self.captures[slot], self.front_lp, self.audio_lp, self.proto,
                                             c["channels"], c["decimation"], c["audio_decimation"], c["fm_gain"])
            gaps[i] = gap(y[self.occupied, self.skip:], refs[slot][self.occupied, self.skip:])
        return {"audio_gap": gaps}

    def work(self) -> dict:
        c = self.config
        return {"sdr": sdr_work.chain_work(self.samples_per_call, c["channels"], c["decimation"], c["front_taps"],
                                           c["channel_taps_per_branch"], c["audio_decimation"], c["audio_taps"])}


ENTRIES = {"chain": Chain}
