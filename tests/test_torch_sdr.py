"""Port parity: the SDR receiver chain (BASELINE config 5) and its stream
stages (polyphase resampling, demodulation, channelizer) against the JAX
package on the same numpy inputs, and against scipy float64 definitions.

Tolerances are the JAX tests' (tests/test_stream.py, test_parallel.py):
1e-5 / 2e-5 / 2e-4 for the resamplers against lfilter, 1e-4 abs for the
chain against JAX, 1e-4 of the reference's peak for the channelizer's
mixer definition. FM demod outputs are compared as wrapped phase
differences (atan2 may land on either side of +-pi), and the end-to-end
comparisons run on FM carriers in every channel, never on bare noise.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu.models import SDRChain as JSDRChain
from chowdsp_fft_tpu.models import SDRChainConfig as JSDRChainConfig
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import convert, models
from chowdsp_fft_tpu_torch import stream as pstream


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)


def lfilter_ref(h, x):
    x = np.asarray(x)
    return sig.lfilter(np.asarray(h, np.float64), [1.0], x.astype(np.result_type(x, np.float64)), axis=-1)


def wrapped(a):
    return np.angle(np.exp(1j * np.asarray(a, np.float64)))


# ---------------------------------------------------------------------------
# Polyphase
# ---------------------------------------------------------------------------


def test_design_lowpass_matches_jax():
    for taps, cutoff, window in ((101, 0.25, "hamming"), (64, 0.5, "blackman"), (33, 0.1, "none")):
        h = pstream.design_lowpass(taps, cutoff, window, device="cpu")
        assert h.dtype == torch.float32 and abs(float(h.sum()) - 1.0) < 1e-6
        np.testing.assert_array_equal(np_(h), np.asarray(jstream.design_lowpass(taps, cutoff, window)))


@pytest.mark.parametrize("t,block", [(4096, 4096), (20000, 2048)])
def test_polyphase_decimate_matches_jax_and_lfilter(t, block):
    """Short (one conv) and framed (t > 2*block) paths."""
    taps, d = 48, 4
    x = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    h = np_(pstream.design_lowpass(taps, 1.0 / d, device="cpu"))
    y = pstream.polyphase_decimate(torch.from_numpy(x), torch.from_numpy(h), d, block=block)
    assert y.shape == (2, t // d)
    close(y, np.asarray(jstream.polyphase_decimate(x, h, d, block=block)), 1e-5)
    close(y, lfilter_ref(h, x)[..., ::d], 1e-5)


def test_polyphase_decimate_length_consistent_across_block():
    x = np.random.default_rng(3).standard_normal(1001).astype(np.float32)
    h = (np.random.default_rng(4).standard_normal(21) / 4).astype(np.float32)
    a = pstream.polyphase_decimate(torch.from_numpy(x), torch.from_numpy(h), 3, block=4096)
    b = pstream.polyphase_decimate(torch.from_numpy(x), torch.from_numpy(h), 3, block=256)
    assert a.shape == b.shape == (1001 // 3,)
    close(a, b, 1e-5)


def test_polyphase_interpolate_zero_state_alignment():
    """y[n] = factor * sum_k h[k] u[n-k] (zero state), against JAX and lfilter."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(257).astype(np.float32)
    h = (rng.standard_normal(33) / 8).astype(np.float32)
    up = 4
    y = pstream.polyphase_interpolate(torch.from_numpy(x), torch.from_numpy(h), up)
    u = np.zeros(x.size * up)
    u[::up] = x
    close(y, up * lfilter_ref(h, u), 2e-5)
    close(y, np.asarray(jstream.polyphase_interpolate(x, h, up)), 2e-5)


def test_polyphase_interpolate_framed_matches_short_and_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(20000).astype(np.float32)
    h = (rng.standard_normal(63) / 8).astype(np.float32)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    y_framed = pstream.polyphase_interpolate(xt, ht, 2, block=2048)
    close(y_framed, pstream.polyphase_interpolate(xt, ht, 2, block=100000), 2e-5)
    close(y_framed, np.asarray(jstream.polyphase_interpolate(x, h, 2, block=2048)), 2e-5)


def test_polyphase_interpolate_tone():
    fs, f0, up = 1000.0, 37.0, 4
    x = np.sin(2 * np.pi * f0 * np.arange(2048) / fs).astype(np.float32)
    y = np_(pstream.polyphase_interpolate(torch.from_numpy(x), pstream.design_lowpass(64, 1.0 / up, device="cpu"), up))
    assert y.shape[-1] == 2048 * up
    spec = np.abs(np.fft.rfft(y[1000:-1000] * np.hanning(y.size - 2000)))
    assert abs(np.argmax(spec) - f0 / (fs * up / 2) * (spec.size - 1)) <= 2


def test_polyphase_updown_roundtrip_alignment():
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    up = 4
    h = pstream.design_lowpass(128, 0.9 / up, device="cpu")
    y = pstream.polyphase_decimate(pstream.polyphase_interpolate(torch.from_numpy(x), h, up), h, up)
    u = np.zeros(x.size * up)
    u[::up] = x
    ref = lfilter_ref(np_(h), up * lfilter_ref(np_(h), u))[::up][: y.shape[-1]]
    close(y, ref, 2e-4)


def test_fp32_convolutions_restores_the_callers_setting():
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    try:
        for setting in (True, False):
            cudnn.allow_tf32 = setting
            with pstream.polyphase.fp32_convolutions():
                assert cudnn.allow_tf32 is False
            assert cudnn.allow_tf32 is setting
    finally:
        cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Demod
# ---------------------------------------------------------------------------


def test_fm_demod_matches_jax_and_recovers_message():
    fs = 48000.0
    t = np.arange(8192) / fs
    msg = np.sin(2 * np.pi * 400 * t)
    kf = 2 * np.pi * 3000 / fs
    rng = np.random.default_rng(8)
    z = (np.exp(1j * np.cumsum(kf * msg)) + 0.05 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size)))
    z = z.astype(np.complex64)
    y = pstream.fm_demod(torch.from_numpy(z), gain=1.0 / kf)
    assert y.dtype == torch.float32 and y.shape == (8192,)
    jy = np.asarray(jstream.fm_demod(z, gain=1.0 / kf))
    assert np.abs(wrapped((np_(y) - jy) * kf)).max() < 1e-5
    clean = np.exp(1j * np.cumsum(kf * msg)).astype(np.complex64)
    close(pstream.fm_demod(torch.from_numpy(clean), gain=1.0 / kf)[10:], msg[10:], 0.02)


def test_am_demod():
    z = ((3.0 + 0j) * np.exp(1j * np.linspace(0, 10, 100))).astype(np.complex64)
    got = pstream.am_demod(torch.from_numpy(z))
    close(got, 3.0, 1e-5)
    close(got, np.asarray(jstream.am_demod(z)), 1e-6)


@pytest.mark.parametrize("t", [1, 7, 8192])
def test_dc_block_matches_jax_and_lfilter(t):
    x = (np.random.default_rng(t).standard_normal((2, t)) + 5.0).astype(np.float32)
    y = pstream.dc_block(torch.from_numpy(x))
    ref = sig.lfilter([1, -1], [1, -0.995], x.astype(np.float64), axis=-1)
    close(y, ref, 1e-3)
    close(y, np.asarray(jstream.dc_block(x)), 1e-4)
    if t == 8192:
        assert abs(float(y[:, 4000:].mean())) < 0.15


# ---------------------------------------------------------------------------
# Channelizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [16, 256, 384])
def test_channelizer_matches_jax(channels):
    """C = 16 and 256 run the small-N direct DFT (K5), C = 384 the complex
    Stockham kernel (K4)."""
    c, steps = channels, 48
    rng = np.random.default_rng(c)
    z = (rng.standard_normal(c * steps + 5) + 1j * rng.standard_normal(c * steps + 5)).astype(np.complex64)
    got = pstream.channelize(torch.from_numpy(z), c)
    want = np.asarray(jstream.channelize(z, c))
    assert got.shape == (c, steps) and got.dtype == torch.complex64
    scale = np.abs(want).max()
    close(got, want, 1e-5 * scale)


def test_channelizer_matches_mixer_definition():
    """mix-down -> prototype lowpass -> decimate, the independent
    definition (test_stream.py), on batched input."""
    c, k, steps = 16, 8, 96
    n = np.arange(c * steps)
    rng = np.random.default_rng(16)
    z = (rng.standard_normal((2, c * steps)) + 1j * rng.standard_normal((2, c * steps))).astype(np.complex64)
    ch_mod = pstream.Channelizer(c, k, device="cpu")
    got = np_(ch_mod(torch.from_numpy(z)))
    assert got.shape == (2, c, steps)
    proto = np.asarray(jstream.design_lowpass(c * k, 1.0 / c), np.float64)
    for ch in (0, 3, c - 1):
        mixed = z.astype(np.complex128) * np.exp(-2j * np.pi * ch * n / c)
        ref = lfilter_ref(proto, mixed)[..., c - 1 :: c][..., :steps] * np.exp(2j * np.pi * ch * (c - 1) / c) / c
        err = np.abs(got[:, ch] - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (ch, err)


def test_channelizer_real_input_matches_jax():
    c, steps = 32, 64
    x = np.random.default_rng(32).standard_normal(c * steps).astype(np.float32)
    got = pstream.channelize(torch.from_numpy(x), c)
    close(got, np.asarray(jstream.channelize(x, c)), 1e-5)


def test_channelizer_invalid_channels():
    with pytest.raises(ct.InvalidSizeError):
        pstream.Channelizer(7)


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


def fm_carriers(c: int, dec: int, t: int, seed: int, noise: float = 0.01) -> np.ndarray:
    """An FM carrier at the centre of every channel of the post-decimation
    bank (each with its own tone), plus a little noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(t, dtype=np.float64)
    iq = np.zeros(t, np.complex128)
    for ch in range(c):
        f = (ch if ch < c // 2 else ch - c) / (c * dec)
        msg = np.sin(2 * np.pi * rng.uniform(0.0005, 0.002) * n + rng.uniform(0, 2 * np.pi))
        phase = 2 * np.pi * f * n + 2 * np.pi * (0.1 / (c * dec)) * np.cumsum(msg)
        iq += np.exp(1j * (phase + rng.uniform(0, 2 * np.pi)))
    iq /= np.sqrt(c)
    iq += noise * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    return iq.astype(np.complex64)


@pytest.mark.parametrize("channels", [16, 256])
def test_sdr_chain_matches_jax(channels):
    """The port chain, built from the JAX chain's filters, against the JAX
    chain on the same capture: channelizer output and audio at 1e-4."""
    cfg = JSDRChainConfig(channels=channels)
    jchain = JSDRChain(cfg)
    t = 2 * channels * 4 * 32
    iq = fm_carriers(channels, 2, t, seed=channels)
    chain = convert.sdr_chain_from_numpy(
        cfg, np.asarray(jchain.front_lp), np.asarray(jchain.audio_lp), np.asarray(jchain.channelizer.hpoly),
        device="cpu",
    )
    assert {name for name, _ in chain.named_buffers()} == {"front_lp", "audio_lp", "channelizer.hpoly"}
    iqt = torch.from_numpy(iq)
    bank = chain.channelizer(chain.front_end(iqt))
    jbank = np.asarray(jchain.channelizer(jchain.front_end(iq)))
    close(bank, jbank, 1e-4)
    audio = chain(iqt)
    assert audio.shape == (channels, 32) and audio.dtype == torch.float32
    close(audio, np.asarray(jchain(iq)), 1e-4)
    # The port's own filter design gives the same chain.
    close(models.SDRChain(models.SDRChainConfig(channels=channels), device="cpu")(iqt), audio, 0.0)


def test_sdr_chain_recovers_fm_tone():
    """test_parallel.py: an FM tone in channel 5 of a 16-channel bank lands
    in channel 5 and demodulates back to its message frequency."""
    cfg = models.SDRChainConfig(channels=16, decimation=2, audio_decimation=2)
    chain = models.SDRChain(cfg, device="cpu")
    c, dec, steps, ch = 16, 2, 1024, 5
    t_wide = np.arange(c * steps * dec, dtype=np.float64)
    msg_f = 0.001
    dev = 0.1 / (c * dec)
    msg = np.sin(2 * np.pi * msg_f * t_wide)
    phase = 2 * np.pi * (ch / (c * dec)) * t_wide + 2 * np.pi * dev * np.cumsum(msg)
    iq = torch.from_numpy(np.exp(1j * phase).astype(np.complex64))
    bank = np_(chain.channelizer(chain.front_end(iq)).abs() ** 2)
    assert bank.mean(axis=-1).argmax() == ch
    a = np_(chain(iq))[ch][32:]
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(a.size)))
    assert abs(spec.argmax() - msg_f * dec * c * cfg.audio_decimation * a.size) <= 2


def test_sdr_chain_moves_with_its_buffers():
    chain = models.SDRChain(models.SDRChainConfig(channels=16), device="cpu").to(torch.float64).to(torch.float32)
    assert chain.front_lp.device.type == "cpu" and chain.channelizer.hpoly.shape == (16, 8)
    with pytest.raises(ValueError):
        convert.sdr_chain_from_numpy(models.SDRChainConfig(channels=16), np.zeros(3), np.zeros(64), np.zeros((16, 8)),
                                     device="cpu")
