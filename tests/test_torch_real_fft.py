"""Port parity: the packed real transforms (the Hopper engine's K1/K2
through their CPU twins, and the Stockham engine), each held against the
JAX package (its Pallas engine in interpret mode on the CPU) and against
float64 numpy on the same inputs.

Tolerance: 2e-7*N max abs error, the JAX package's own bound
(tests/test_pallas_engine.py), for port vs JAX and for either vs float64.
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import hopper_fft, tables

SIZES = [384, 1024, 4096, 16384]
LEADS = [(3,), (2, 3)]


def tol(n):
    return 2.0e-7 * n


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def packed_ref(x):
    """float64 ordered packed planes of real rows."""
    n = x.shape[-1]
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)
    re = spec[..., : n // 2].real.copy()
    im = spec[..., : n // 2].imag.copy()
    im[..., 0] = spec[..., n // 2].real
    return re, im


def close(got, want, n):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=tol(n), rtol=0)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("n", SIZES)
def test_rfft_packed_matches_jax(n, lead):
    assert ct.engine_for(n, "real") == "hopper"
    x = np.random.default_rng(n).standard_normal((*lead, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    ref_re, ref_im = packed_ref(x)
    perm = tables.unordered_perm(n)

    got = ct.rfft_packed(xt)
    want = cf.rfft_packed(x, engine="pallas")
    for g, w, r in zip(got, want, (ref_re, ref_im)):
        assert g.shape == (*lead, n // 2) and g.dtype == torch.float32
        close(g, w, n)
        close(g, r, n)

    got_u = ct.rfft_packed_unordered(xt)
    want_u = cf.rfft_packed_unordered(x, engine="pallas")
    for g, w, r in zip(got_u, want_u, (ref_re, ref_im)):
        close(g, w, n)
        close(g, r[..., perm], n)

    # Canonical wrappers over the packed path.
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)
    close(ct.rfft(xt), spec, n)
    uc = np_(ct.rfft_unordered(xt))
    np.testing.assert_allclose(uc[..., 1:-1], spec[..., perm[1:]], atol=tol(n), rtol=0)
    np.testing.assert_allclose(uc[..., -1], spec[..., -1], atol=tol(n), rtol=0)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("n", SIZES)
def test_irfft_packed_matches_jax(n, lead):
    x = np.random.default_rng(n + 1).standard_normal((*lead, n)).astype(np.float32)
    re, im = (a.astype(np.float32) for a in packed_ref(x))
    perm = tables.unordered_perm(n)
    for ordered in (True, False):
        sre = re if ordered else np.ascontiguousarray(re[..., perm])
        sim = im if ordered else np.ascontiguousarray(im[..., perm])
        if ordered:
            got = ct.irfft_packed(torch.from_numpy(sre), torch.from_numpy(sim))
            want = cf.irfft_packed(sre, sim, engine="pallas")
        else:
            got = ct.irfft_packed_unordered(torch.from_numpy(sre), torch.from_numpy(sim))
            want = cf.irfft_packed_unordered(sre, sim, engine="pallas")
        assert got.shape == (*lead, n) and got.dtype == torch.float32
        # Unscaled: irfft(rfft(x)) == N * x; compare per sample.
        close(np_(got) / n, np.asarray(want) / n, n)
        close(np_(got) / n, x, n)
    # Round trips through the port alone, both orders.
    xt = torch.from_numpy(x)
    close(ct.irfft_packed(*ct.rfft_packed(xt)) / n, x, n)
    close(ct.irfft_packed_unordered(*ct.rfft_packed_unordered(xt)) / n, x, n)
    close(ct.irfft(ct.rfft(xt)) / n, x, n)
    close(ct.irfft_unordered(ct.rfft_unordered(xt)) / n, x, n)


@pytest.mark.parametrize("n", [6, 1458, 279936, 1 << 21])
def test_hopper_engine_out_of_domain_raises(n):
    """N below the small-N direct DFT (8), real N without an even
    composite split (1458 = 2*3^6, 279936 = 2^7*3^7) and N above the
    composite's 2^20 lie outside the JAX engine's domain and the port's:
    auto takes the Stockham engine, an explicit hopper request raises."""
    assert ct.engine_for(n, "real") == "stockham"
    assert not ct.engine_supports("hopper", n, "real")
    x = torch.zeros(2, n)
    with pytest.raises(ValueError, match="does not support"):
        ct.rfft_packed(x, engine="hopper")
    with pytest.raises(ValueError, match="unknown engine"):
        ct.rfft_packed(x, engine="bogus")


def test_engine_dispatch():
    assert ct.available_engines() == ("hopper", "stockham")
    for n in (384, 2048, 4096, 16384):
        assert ct.engine_for(n, "real") == "hopper"
        assert ct.engine_supports("stockham", n, "real")
    assert hopper_fft.MAX_N == 16384
    # The complex surface runs on K4 (and K5 at small N).
    assert ct.engine_for(4096, "complex") == "hopper"


@pytest.mark.parametrize("n", [200, 1920, 32768])
def test_stockham_engine_matches_jax(n):
    x = np.random.default_rng(n + 3).standard_normal((2, 3, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = ct.rfft_packed(xt, engine="stockham")
    want = cf.rfft_packed(x, engine="stockham")
    for g, w in zip(got, want):
        close(g, w, n)
    spec = ct.rfft(xt, engine="stockham")
    close(spec, np.asarray(cf.rfft(x, engine="stockham")), n)
    back = ct.irfft(spec, engine="stockham")
    close(back / n, x, n)
    close(back / n, np.asarray(cf.irfft(np_(spec), engine="stockham")) / n, n)


@pytest.mark.parametrize("n", [60, 256, 1000, 4096])
def test_stockham_complex_matches_jax(n):
    """The Stockham engine's complex transform (its stage loop is also
    the twins' stage loop), both directions, unscaled."""
    from chowdsp_fft_tpu_torch.ops import stockham

    rng = np.random.default_rng(n + 4)
    z = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    got = stockham.cfft(torch.from_numpy(z))
    close(got, np.asarray(cf.fft(z, engine="stockham")), n)
    close(got, np.fft.fft(z.astype(np.complex128)), n)
    back = stockham.cfft(got, direction=ct.FFT_BACKWARD)
    close(back / n, z, n)
