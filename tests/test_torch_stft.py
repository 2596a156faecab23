"""Port parity: the STFT (stream/stft.py) against the JAX package's
``stft``/``istft``/``spectrogram`` and numpy float64, on the same numpy
inputs (test_stream.py's STFT cases). Tolerances are test_stream.py's:
2e-7*n_fft*4 on spectra, 1e-4 on round trips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu_torch import stream as pstream

ROUND_TRIP_ATOL = 1e-4


def spec_tol(n_fft):
    return 2e-7 * n_fft * 4


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_hann_window_is_jax():
    for n in (256, 1024):
        np.testing.assert_array_equal(pstream.hann_window(n), jstream.hann_window(n))


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (512, 128), (1024, 512)])
def test_stft_istft_roundtrip_matches_jax(n_fft, hop):
    t = 8192
    x = np.random.default_rng(n_fft + hop).standard_normal((2, t)).astype(np.float32)
    s = pstream.stft(torch.from_numpy(x), n_fft=n_fft, hop=hop)
    js = np.asarray(jstream.stft(x, n_fft=n_fft, hop=hop))
    assert s.shape == js.shape and s.dtype == torch.complex64
    assert np.abs(np_(s) - js).max() < spec_tol(n_fft)
    back = pstream.istft(s, hop=hop, length=t)
    assert back.shape == x.shape
    assert np.abs(np_(back) - x).max() < ROUND_TRIP_ATOL
    jback = np.asarray(jstream.istft(jnp.asarray(js), hop=hop, length=t))
    assert np.abs(np_(back) - jback).max() < ROUND_TRIP_ATOL


def test_stft_matches_naive_frames():
    """Frame f of the STFT equals rfft(window * x[f*hop-pad : ...])."""
    n_fft, hop, t = 256, 128, 1024
    x = np.random.default_rng(9).standard_normal(t).astype(np.float32)
    s = np_(pstream.stft(torch.from_numpy(x), n_fft=n_fft, hop=hop))
    w = pstream.hann_window(n_fft).astype(np.float64)
    pad = n_fft - hop
    xp = np.pad(x.astype(np.float64), (pad, n_fft))
    for f in (0, 3, 7):
        ref = np.fft.rfft(xp[f * hop : f * hop + n_fft] * w)
        assert np.abs(s[f] - ref).max() < spec_tol(n_fft)


def test_spectrogram_matches_jax():
    x = np.random.default_rng(10).standard_normal(4096).astype(np.float32)
    p = np_(pstream.spectrogram(torch.from_numpy(x), n_fft=512, hop=256))
    assert p.ndim == 2 and p.shape[1] == 257 and p.dtype == np.float32
    assert (p >= 0).all()
    jp = np.asarray(jstream.spectrogram(x, n_fft=512, hop=256))
    assert np.abs(p - jp).max() <= 1e-5 * np.abs(jp).max()


def test_stft_accepts_tensor_window():
    """A tensor window in stft (JAX: a traced one), taken to the host by
    istft for its COLA table; a batch of (2, 3) streams."""
    x = np.random.default_rng(11).standard_normal((2, 3, 2048)).astype(np.float32)
    w = np.hanning(512).astype(np.float32)
    s = pstream.stft(torch.from_numpy(x), n_fft=512, hop=256, window=torch.from_numpy(w))
    assert s.shape[:2] == (2, 3) and s.shape[-1] == 257
    js = np.asarray(jstream.stft(x, n_fft=512, hop=256, window=jnp.asarray(w)))
    assert np.abs(np_(s) - js).max() < spec_tol(512)
    back = pstream.istft(s, hop=256, window=torch.from_numpy(w), length=2048)
    assert torch.equal(back, pstream.istft(s, hop=256, window=w, length=2048))
    # np.hanning (symmetric) is not exactly COLA at hop 256, but the
    # normalisation table divides it out: x comes back.
    assert np.abs(np_(back) - x).max() < ROUND_TRIP_ATOL


def test_stft_refuses_hop_not_dividing_n_fft():
    with pytest.raises(ValueError, match="hop"):
        pstream.stft(torch.zeros(1024), n_fft=512, hop=200)
    with pytest.raises(ValueError, match="hop"):
        pstream.istft(torch.zeros(4, 257, dtype=torch.complex64), hop=200)
