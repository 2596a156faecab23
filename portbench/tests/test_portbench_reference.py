"""The float64 references against numpy at small sizes."""

import numpy as np
import pytest
import torch

from portbench.reference import compare, convolution, precision, real_fft


def test_linear_convolution_matches_numpy():
    rng = np.random.default_rng(0)
    x, h = rng.standard_normal((3, 500)), rng.standard_normal((3, 70))
    want = np.stack([np.convolve(x[c], h[c])[:500] for c in range(3)])
    got = convolution.linear(torch.from_numpy(x).float(), torch.from_numpy(h).float()).numpy()
    np.testing.assert_allclose(got, np.stack([np.convolve(x[c].astype(np.float32).astype(np.float64),
                                                          h[c].astype(np.float32).astype(np.float64))[:500]
                                              for c in range(3)]), atol=1e-12)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_linear_convolution_across_channel_blocks():
    """More channels than one block of the reference holds, each by its own IR."""
    rng = np.random.default_rng(1)
    channels = convolution.CHANNELS_PER_BLOCK * 2 + 3
    x, h = rng.standard_normal((channels, 200)), rng.standard_normal((channels, 33))
    want = np.stack([np.convolve(x[c], h[c])[:200] for c in range(channels)])
    got = convolution.linear(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n", [8, 512, 4096, 16384])
def test_rfft_packed_matches_numpy(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    spec = np.fft.rfft(x.astype(np.float64))
    re, im = real_fft.rfft_packed(torch.from_numpy(x))
    assert re.dtype == torch.float64 and re.shape == (5, n // 2)
    np.testing.assert_allclose(re.numpy()[:, 1:], spec.real[:, 1:-1], atol=1e-9)
    np.testing.assert_allclose(im.numpy()[:, 1:], spec.imag[:, 1:-1], atol=1e-9)
    np.testing.assert_allclose(re.numpy()[:, 0], spec.real[:, 0], atol=1e-9)  # DC
    np.testing.assert_allclose(im.numpy()[:, 0], spec.real[:, -1], atol=1e-9)  # Nyquist


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.0, 0.0, 1 + 2 ** -12])
    got = precision.round_tf32(x)
    assert got.tolist() == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -3.0, 0.0, 1.0]  # ties to even
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    rel = ((precision.round_tf32(r) - r).abs() / r.abs()).max()
    assert 2 ** -12 < rel <= 2 ** -11


def test_gap_is_max_over_rms():
    ref = torch.tensor([3.0, -4.0, 0.0, 0.0], dtype=torch.float64)
    assert compare.gap(ref + torch.tensor([0.0, 0.25, 0.0, 0.0]), ref) == pytest.approx(0.25 / 2.5)
    assert not compare.gap(ref * float("nan"), ref) <= 1.0
