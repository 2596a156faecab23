"""Port parity: the fused convolve-inverse ``convolve_irfft_packed`` (the
Hopper engine's K3 through its CPU twin) against the JAX package's Pallas
engine (interpret mode on the CPU) and against a float64 circular
convolution, on the same inputs. Tolerance: 2e-7*N max abs error, the
JAX package's own bound (tests/test_pallas_engine.py).
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import tables

SIZES = [384, 1024, 4096, 16384]
LEADS = [(3,), (2, 3)]


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, n):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=2.0e-7 * n, rtol=0)


def packed_ref(x):
    """float64 ordered packed planes of real rows."""
    n = x.shape[-1]
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)
    re = spec[..., : n // 2].real.copy()
    im = spec[..., : n // 2].imag.copy()
    im[..., 0] = spec[..., n // 2].real
    return re, im


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("n", SIZES)
def test_convolve_irfft_packed_matches_jax(n, lead, shared, ordered):
    rng = np.random.default_rng(n + 2)
    x = rng.standard_normal((*lead, n)).astype(np.float32)
    h_lead = (1,) * len(lead) if shared else lead
    h = (rng.standard_normal((*h_lead, n)) / np.sqrt(n)).astype(np.float32)
    sel = slice(None) if ordered else tables.unordered_perm(n)
    are, aim = (np.ascontiguousarray(a[..., sel], dtype=np.float32) for a in packed_ref(x))
    bre, bim = (np.ascontiguousarray(a[..., sel], dtype=np.float32) for a in packed_ref(h))
    if shared:  # one (N/2,) filter spectrum broadcast over A's batch
        bre, bim = bre.reshape(-1), bim.reshape(-1)
    want = cf.convolve_irfft_packed(are, aim, bre, bim, scaling=1.0 / n, engine="pallas", ordered=ordered)
    t = torch.from_numpy
    got = ct.convolve_irfft_packed(t(are), t(aim), t(bre), t(bim), scaling=1.0 / n, ordered=ordered)
    assert got.shape == (*lead, n)
    close(got, want, n)
    circ = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h.astype(np.float64)), n=n)
    close(got, circ, n)
    # A tensor scaling takes the unfused composition: same result.
    got_t = ct.convolve_irfft_packed(
        t(are), t(aim), t(bre), t(bim), scaling=torch.tensor(1.0 / n), ordered=ordered
    )
    close(got_t, np_(got), n)


def test_convolve_irfft_packed_batch_mismatch_raises():
    n = 1024
    a = torch.zeros(3, n // 2)
    b = torch.zeros(2, n // 2)
    with pytest.raises(ValueError, match="B batch"):
        ct.convolve_irfft_packed(a, a, b, b, scaling=0.5)
