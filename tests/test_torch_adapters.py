"""Port parity of the adapters: ``tests/test_adapters.py`` case for case on
the port (numpy float64 as the reference), then the port's adapters
against the JAX package's on the same seeded inputs (2e-7*N), and where a
host array goes."""

import numpy as np
import pytest
import torch

from chowdsp_fft_tpu.adapters import JuceStyleFFT as JaxJuce
from chowdsp_fft_tpu.adapters import numpy_like as jnl
from chowdsp_fft_tpu_torch.adapters import JuceStyleFFT
from chowdsp_fft_tpu_torch.adapters import numpy_like as nl
from torch_parity import crandn, max_abs, np_, tol

CPU = "cpu"


# -- tests/test_adapters.py, case for case ----------------------------------


def test_numpy_like_fft_ifft(rng):
    z = crandn(rng, (3, 512))
    np.testing.assert_allclose(np_(nl.fft(z, device=CPU)), np.fft.fft(z), atol=1e-3)
    np.testing.assert_allclose(np_(nl.ifft(z, device=CPU)), np.fft.ifft(z), atol=1e-5)


def test_numpy_like_rfft_irfft_scaled(rng):
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    np.testing.assert_allclose(np_(nl.rfft(x, device=CPU)), np.fft.rfft(x), atol=1e-3)
    s = np.fft.rfft(x).astype(np.complex64)
    np.testing.assert_allclose(np_(nl.irfft(s, device=CPU)), np.fft.irfft(s), atol=1e-5)


def test_numpy_like_axis_and_n(rng):
    x = rng.standard_normal((64, 5)).astype(np.float32)
    np.testing.assert_allclose(np_(nl.rfft(x, axis=0, device=CPU)), np.fft.rfft(x, axis=0), atol=1e-4)
    got = np_(nl.fft(x[:, 0] + 0j, n=128, device=CPU))
    np.testing.assert_allclose(got, np.fft.fft(x[:, 0], n=128), atol=1e-4)


def test_numpy_like_freqs():
    np.testing.assert_allclose(np_(nl.fftfreq(64, 0.5, device=CPU)), np.fft.fftfreq(64, 0.5), atol=0)
    np.testing.assert_allclose(np_(nl.rfftfreq(64, device=CPU)), np.fft.rfftfreq(64), atol=0)


def test_juce_complex_roundtrip(rng):
    f = JuceStyleFFT(order=9, device=CPU)  # 512
    assert f.get_size() == 512
    z = crandn(rng, 512)
    fwd = f.perform(z)
    np.testing.assert_allclose(np_(fwd), np.fft.fft(z), atol=1e-3)
    back = f.perform(fwd, inverse=True)
    np.testing.assert_allclose(np_(back), z, atol=1e-5)  # JUCE: inverse scaled


def test_juce_real_layout(rng):
    f = JuceStyleFFT(order=8, device=CPU)  # 256
    x = rng.standard_normal(256).astype(np.float32)
    buf = np_(f.perform_real_only_forward_transform(x))
    assert buf.shape == (258,)  # (N/2 + 1) complex interleaved
    ref = np.fft.rfft(x.astype(np.float64))
    np.testing.assert_allclose(buf[0::2], ref.real, atol=1e-4)
    np.testing.assert_allclose(buf[1::2], ref.imag, atol=1e-4)
    back = np_(f.perform_real_only_inverse_transform(buf))
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_juce_frequency_only(rng):
    f = JuceStyleFFT(order=6, device=CPU)
    x = rng.standard_normal(64).astype(np.float32)
    mags = np_(f.perform_frequency_only_forward_transform(x))
    assert mags.shape == (64,)
    np.testing.assert_allclose(mags[:33], np.abs(np.fft.rfft(x)), atol=1e-4)
    assert np.all(mags[33:] == 0)


def test_juce_small_order(rng):
    f = JuceStyleFFT(order=2, device=CPU)
    z = crandn(rng, 4)
    np.testing.assert_allclose(np_(f.perform(z)), np.fft.fft(z), atol=1e-5)


def test_numpy_like_irfft_odd_n(rng):
    spec = crandn(rng, 5)
    got = np_(nl.irfft(spec, n=9, device=CPU))
    ref = np.fft.irfft(spec.astype(np.complex128), n=9)
    assert got.shape == (9,)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_juce_small_orders(rng):
    """Orders 1-4 (sizes 2..16), real N=2 included."""
    for order in (1, 2, 4):
        n = 1 << order
        f = JuceStyleFFT(order, device=CPU)
        x = rng.standard_normal(n).astype(np.float32)
        out = np_(f.perform_real_only_forward_transform(x))
        ref = np.fft.rfft(x.astype(np.float64))
        got = out[: 2 * (n // 2 + 1)]
        spec = got[0::2] + 1j * got[1::2]
        assert np.abs(spec - ref).max() < 1e-4, order


# -- the port against the JAX package's adapters ----------------------------


@pytest.mark.parametrize("n,rows", [(64, 3), (512, 2), (1024, 2), (480, 3)])
def test_numpy_like_matches_jax(n, rows):
    rng = np.random.default_rng(n + rows)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    z = crandn(rng, (rows, n))
    pairs = (
        (nl.fft(z, device=CPU), jnl.fft(z)),
        (nl.ifft(z, device=CPU), jnl.ifft(z)),
        (nl.rfft(x, device=CPU), jnl.rfft(x)),
    )
    for got, want in pairs:
        assert got.shape == want.shape
        assert max_abs(got, want) <= tol(n)
    spec = np.fft.rfft(x).astype(np.complex64)
    got, want = nl.irfft(spec, device=CPU), jnl.irfft(spec)
    assert got.shape == want.shape and max_abs(got, want) <= tol(n)


def test_numpy_like_axis_n_and_odd_irfft_match_jax(rng):
    x = rng.standard_normal((96, 3)).astype(np.float32)
    z = crandn(rng, (96, 3))
    for got, want in (
        (nl.rfft(x, axis=0, device=CPU), jnl.rfft(x, axis=0)),
        (nl.fft(z, n=128, axis=0, device=CPU), jnl.fft(z, n=128, axis=0)),
        (nl.ifft(z, n=64, axis=0, device=CPU), jnl.ifft(z, n=64, axis=0)),
        (nl.rfft(x[:, 0], n=160, device=CPU), jnl.rfft(x[:, 0], n=160)),
        (nl.irfft(z, n=25, axis=0, device=CPU), jnl.irfft(z, n=25, axis=0)),
        (nl.irfft(z[:17], axis=0, device=CPU), jnl.irfft(z[:17], axis=0)),
    ):
        assert got.shape == want.shape
        assert max_abs(got, want) <= tol(128)


@pytest.mark.parametrize("order", [1, 4, 5, 8, 9, 10])
def test_juce_matches_jax(order):
    rng = np.random.default_rng(order)
    n = 1 << order
    mine, ref = JuceStyleFFT(order, device=CPU), JaxJuce(order)
    x = rng.standard_normal((3, n)).astype(np.float32)
    z = crandn(rng, (3, n))
    fwd = mine.perform_real_only_forward_transform(x)
    for got, want in (
        (mine.perform(z), ref.perform(z)),
        (mine.perform(z, inverse=True), ref.perform(z, inverse=True)),
        (fwd, ref.perform_real_only_forward_transform(x)),
        (mine.perform_real_only_inverse_transform(fwd), ref.perform_real_only_inverse_transform(np_(fwd))),
        (mine.perform_frequency_only_forward_transform(x), ref.perform_frequency_only_forward_transform(x)),
    ):
        assert got.shape == want.shape
        assert max_abs(got, want) <= tol(n)


def test_tensors_keep_their_device_and_host_arrays_go_to_the_card():
    """A tensor stays where it is; a host array goes to ``device``, by
    default the card (here, without one, asking for it raises)."""
    x = np.ones((2, 64), np.float32)
    assert nl.rfft(torch.from_numpy(x)).device.type == "cpu"
    assert JuceStyleFFT(6).perform_real_only_forward_transform(torch.from_numpy(x)).device.type == "cpu"
    assert nl.fftfreq(8, device=CPU).device.type == "cpu"
    calls = (lambda: nl.rfft(x), lambda: nl.fft(x + 0j), lambda: JuceStyleFFT(6).perform(x + 0j),
             lambda: nl.fftfreq(8))
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                call()
