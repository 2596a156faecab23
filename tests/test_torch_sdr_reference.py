"""The SDR receiver chain (BASELINE config 5) against the benchmark's
float64 reference (``portbench/reference/sdr.py``) at small sizes on the
CPU: the whole chain with its designed filters on seeded FM carriers,
each stage with seeded random, asymmetric taps, and planted faults that
must fail; and the chain's work (``portbench/sdr_work.py``).

Tolerances: max |out - ref| / rms(ref), as the benchmark's ``audio_gap``.
The chain computes in float32 on the wideband stream, so each stage
lands within a few 1e-7 of its reference and the audio within 1.5e-6
(C = 256, 2^18 samples); 2e-5 leaves room for other sizes and seeds.
Computing in TF32 (operands rounded to 10 mantissa bits) reads 1e-4 and
more, so it fails.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import scipy.signal as sig
import torch

from chowdsp_fft_tpu_torch import models
from chowdsp_fft_tpu_torch.stream import Channelizer
from portbench import roofline, sdr_work, traffic
from portbench.reference import sdr as reference
from portbench.reference import compare
from portbench.reference.precision import round_tf32
from portbench.systems import sdr as system

TOL = 2e-5
CONFIG = json.loads((pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs" / "sdr256.json").read_text())


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """``compare.gap`` over the real and imaginary planes of complex outputs."""
    if ref.is_complex():
        out, ref = torch.view_as_real(out.to(torch.complex128)), torch.view_as_real(ref)
    return compare.gap(out, ref)


def small_config(channels: int) -> dict:
    occupied = system.occupied_channels(reference.lowpass(64, 0.5), channels, 2)
    return CONFIG | {"channels": channels, "occupied": occupied}


def randomize(chain: models.SDRChain, seed: int) -> torch.Tensor:
    """Seeded random, asymmetric taps in all three filter buffers; the
    prototype, in natural order, is returned and goes in through
    ``Channelizer.polyphase``."""
    gen = torch.Generator().manual_seed(seed)
    c = chain.config
    proto = torch.randn(c.channels * c.channel_taps_per_branch, generator=gen) / 8
    with torch.no_grad():
        chain.front_lp.copy_(torch.randn(c.front_taps, generator=gen) / math.sqrt(c.front_taps))
        chain.audio_lp.copy_(torch.randn(c.audio_taps, generator=gen) / math.sqrt(c.audio_taps))
        chain.channelizer.hpoly.copy_(Channelizer.polyphase(proto, c.channels))
    return proto


def cell(channels: int, seed: int):
    """The benchmark's system at a small size on the CPU: its chain, its
    captures (T = 2 C 4 64) and the reference's filters."""
    mix = {"entry": "chain", "capture_samples": 2 * channels * 4 * 64, "ring": 1, "warmup_calls": 1,
           "trace_calls": 1, "enqueue_calls": 0, "kept": 1}
    return system.Chain(small_config(channels), traffic.Plan(mix, seed), seed, "cpu")


# ---------------------------------------------------------------------------
# The reference against independent definitions
# ---------------------------------------------------------------------------


def test_reference_stages_match_scipy():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
    h = rng.standard_normal(21)
    got = reference.decimate(torch.from_numpy(x), torch.from_numpy(h), 3).numpy()
    np.testing.assert_allclose(got, sig.upfirdn(h, x, 1, 3)[: 1000 // 3], atol=1e-12)
    c, taps = 8, 32
    proto = rng.standard_normal(taps)
    z = rng.standard_normal(c * 20) + 1j * rng.standard_normal(c * 20)
    bank = reference.channelize(torch.from_numpy(z), torch.from_numpy(proto), c).numpy()
    for ch in range(c):
        mixed = z * np.exp(-2j * np.pi * ch * np.arange(z.size) / c)
        want = sig.lfilter(proto, [1.0], mixed)[c - 1:: c] * np.exp(2j * np.pi * ch * (c - 1) / c) / c
        np.testing.assert_allclose(bank[ch], want, atol=1e-12)
    d = reference.discriminate(torch.from_numpy(z)).numpy()
    assert d[0] == 0.0
    np.testing.assert_allclose(d[1:], np.angle(z[1:] * np.conj(z[:-1])), atol=1e-15)


@pytest.mark.parametrize("taps, cutoff", [(64, 1 / 2), (64, 1 / 4), (2048, 1 / 256), (128, 1 / 16)])
def test_reference_filters_match_firwin(taps, cutoff):
    """The reference's low-pass is scipy's Hamming-windowed sinc at unit
    gain at DC, and its three filters are the chain's cutoffs."""
    want = sig.firwin(taps, cutoff, window="hamming", scale=False)
    np.testing.assert_allclose(reference.lowpass(taps, cutoff).numpy(), want / want.sum(), rtol=0, atol=1e-15)
    front, audio, proto = reference.filters(taps // 8, 2, 64, 8, 4, taps)
    assert torch.equal(front, reference.lowpass(64, 1 / 2)) and torch.equal(audio, reference.lowpass(taps, 1 / 4))
    assert torch.equal(proto, reference.lowpass(taps, 8 / taps))


def test_reference_sets_no_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False


# ---------------------------------------------------------------------------
# The chain against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [16, 32])
def test_chain_matches_reference_on_fm_carriers(channels):
    """The designed filters, seeded FM carriers in the occupied channels:
    the benchmark's own comparison (``Chain.check``) of the chain's audio."""
    entry = cell(channels, seed=channels)
    out = entry.call(0)
    assert out.shape == (channels, 2 * channels * 4 * 64 // (2 * channels * 4)) and out.dtype == torch.float32
    assert entry.check({0: out})["audio_gap"][0] < TOL


def _stage(chain: models.SDRChain, proto: torch.Tensor, name: str, gen: torch.Generator):
    """(program, reference) of one stage on seeded inputs; ``proto`` is
    the channelizer's prototype in natural order."""
    c = chain.config
    if name in ("front_end", "front_end_framed"):
        t = 2 * c.channels * 4 * 64 if name == "front_end" else 9000  # framed above 2 x 4096 samples
        iq = torch.complex(torch.randn(t, generator=gen), torch.randn(t, generator=gen))
        return chain.front_end(iq), reference.decimate(iq, chain.front_lp.double(), c.decimation)
    if name == "channelizer":
        z = torch.complex(torch.randn(c.channels * 64, generator=gen), torch.randn(c.channels * 64, generator=gen))
        return chain.channelizer(z), reference.channelize(z, proto.double(), c.channels)
    # The audio stage, on streams whose phase steps stay inside +-2 rad,
    # from the first audio sample that does not read the discriminator's
    # step 0 (the angle of two signed zeros, which may read +-pi).
    steps = 9000 if name == "audio_framed" else 256
    phase = torch.cumsum(4 * torch.rand(c.channels, steps, generator=gen, dtype=torch.float64) - 2, -1)
    z = torch.polar(1 + 0.1 * torch.rand(c.channels, steps, generator=gen, dtype=torch.float64), phase)
    z = z.to(torch.complex64)
    first = -(-c.audio_taps // c.audio_decimation)
    ref = reference.audio(z, chain.audio_lp.double(), c.audio_decimation, c.fm_gain)
    return chain.back_end(z)[..., first:], ref[..., first:]


STAGES = ["front_end", "front_end_framed", "channelizer", "audio", "audio_framed"]


@pytest.mark.parametrize("channels", [16, 32])
@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_reference_with_random_taps(channels, name):
    chain = models.SDRChain(models.SDRChainConfig(channels=channels), device="cpu")
    proto = randomize(chain, seed=channels)
    out, ref = _stage(chain, proto, name, torch.Generator().manual_seed(7))
    assert out.shape == ref.shape
    assert gap(out, ref) < TOL


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [16, 32])
def test_a_delayed_front_end_fails(channels):
    entry = cell(channels, seed=channels)
    front_end = entry.chain.front_end
    entry.chain.front_end = lambda iq: torch.nn.functional.pad(front_end(iq), (1, 0))[..., :-1]
    assert entry.check({0: entry.call(0)})["audio_gap"][0] > 100 * TOL


@pytest.mark.parametrize("channels", [16, 32])
def test_unflipped_branch_filters_fail(channels):
    """The branch filters applied in the wrong order (a second flip): with
    asymmetric taps the channelizer no longer meets the reference."""
    chain = models.SDRChain(models.SDRChainConfig(channels=channels), device="cpu")
    proto = randomize(chain, seed=channels)
    _, ref = _stage(chain, proto, "channelizer", torch.Generator().manual_seed(7))
    with torch.no_grad():
        chain.channelizer.hpoly.copy_(torch.flip(chain.channelizer.hpoly, (-1,)))
    out, _ = _stage(chain, proto, "channelizer", torch.Generator().manual_seed(7))
    assert gap(out, ref) > 100 * TOL


@pytest.mark.parametrize("channels", [16, 32])
def test_an_unflipped_channelizer_fails_the_benchmark_check(channels, monkeypatch):
    """A Channelizer whose constructor stores each branch oldest-first: the
    benchmark's own check (the reference's filters come from their
    definition, not from the chain's buffers) fails it."""
    monkeypatch.setattr(Channelizer, "polyphase", staticmethod(lambda proto, c: proto.reshape(-1, c).T))
    entry = cell(channels, seed=channels)
    assert entry.check({0: entry.call(0)})["audio_gap"][0] > 100 * TOL


@pytest.mark.parametrize("channels", [16, 32])
def test_tf32_fails(channels):
    """The benchmark's control (every convolution's operands rounded to
    TF32) and the reference fed TF32 inputs alone both fail."""
    entry = cell(channels, seed=channels)
    assert entry.check({0: entry.control(0)})["audio_gap"][0] > 10 * TOL
    iq = entry.captures[0]
    rounded = torch.complex(round_tf32(iq.real), round_tf32(iq.imag))
    c = entry.chain.config
    inputs_only = reference.chain(rounded, entry.front_lp, entry.audio_lp, entry.proto, c.channels, c.decimation,
                                  c.audio_decimation)
    assert entry.check({0: inputs_only.float()})["audio_gap"][0] > TOL


def test_noise_only_channels_are_left_out():
    """The channels the front end does not pass carry noise alone: the
    check reads only the occupied ones, and the start-up it skips is the
    zero-state fill (here 18 audio samples)."""
    entry = cell(32, seed=3)
    assert entry.skip == system.clean_audio_start(entry.config) == 18
    assert 0 < len(entry.config["occupied"]) < 32
    out = entry.call(0).clone()
    idle = [c for c in range(32) if c not in entry.config["occupied"]]
    out[idle] = 1e3
    out[:, : entry.skip] = 1e3
    assert entry.check({0: out})["audio_gap"][0] < TOL


# ---------------------------------------------------------------------------
# The chain's work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("samples, channels, want", [
    (1 << 24, 256, (142_606_336, 2_147_483_648 + 268_435_456 + 335_544_320 + 67_108_864 + 268_435_456)),
    (1 << 15, 32, (8 * 32768 + 4 * 32 * 128, 2 * 16384 * 128 + 2 * 32 * 512 * 16 + 512 * 5 * 32 * 5 + 8 * 32 * 512
                   + 32 * 128 * 128)),
])
def test_chain_work(samples, channels, want):
    got = sdr_work.chain_work(samples, channels, 2, 64, 8, 4, 64)
    assert got == (float(want[0]), float(want[1]))
    if samples == 1 << 24:
        assert got[1] == 3_087_007_744
        assert roofline.least_seconds(*got) == pytest.approx(0.0461e-3, rel=1e-3)
