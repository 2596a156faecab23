"""Port parity: the small-N direct DFT (K5, through its plain versions on
the CPU) against the JAX package (its Pallas engine in interpret mode)
and float64 numpy, at test_pallas_engine.py's small-N sizes.

Tolerance: 2e-7*N max abs error (the JAX package's bound); the N = 32
conv round trip uses 20x that, as the JAX test does. Also covers what
the small sizes changed elsewhere: the natural-order unordered layout at
N <= 256 carries JAX filter state unchanged, and the fused convolve
gate leaves K5 sizes to the unfused product + K5 inverse.
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu_torch import convert
from chowdsp_fft_tpu_torch import stream as pstream
from chowdsp_fft_tpu_torch.ops import hopper_fft, hopper_small

C_SIZES = [8, 32, 64, 96, 128, 160, 240, 256, 320, 480]
R_SIZES = [32, 64, 96, 128, 192, 256, 480]


def tol(n):
    return 2.0e-7 * n


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)


def rand_complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", C_SIZES)
def test_small_cfft_matches_jax(n):
    assert ct.engine_for(n, "complex") == "hopper" and hopper_small.in_domain(n)
    z = rand_complex(n, (7, n))  # ragged batch
    zt = torch.from_numpy(z)
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    y = ct.fft(zt)
    close(y, cf.fft(z, engine="pallas"), tol(n))
    close(y, ref, tol(n))
    back = ct.ifft(y)
    close(back / n, np.asarray(cf.ifft(np_(y), engine="pallas")) / n, tol(n))
    close(back / n, z, tol(n))
    # Natural order is the unordered layout here, as in JAX.
    close(ct.fft_unordered(zt), y, 0.0)
    close(ct.fft_unordered(zt), cf.fft_unordered(z, engine="pallas"), tol(n))
    yr, yi = ct.fft_planes(torch.from_numpy(np.ascontiguousarray(z.real)), torch.from_numpy(np.ascontiguousarray(z.imag)))
    close(torch.complex(yr, yi), y, 0.0)


@pytest.mark.parametrize("n", R_SIZES)
def test_small_rfft_packed_and_canonical(n):
    assert ct.engine_for(n, "real") == "hopper"
    x = np.random.default_rng(n + 1).standard_normal((5, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    re, im = ct.rfft_packed(xt)
    jre, jim = cf.rfft_packed(x, engine="pallas")
    close(re, jre, tol(n))
    close(im, jim, tol(n))
    close(re[:, 1:], ref[:, 1 : n // 2].real, tol(n))
    close(im[:, 1:], ref[:, 1 : n // 2].imag, tol(n))
    close(re[:, 0], ref[:, 0].real, tol(n))  # DC
    close(im[:, 0], ref[:, -1].real, tol(n))  # Nyquist in im[0]
    back = ct.irfft_packed(re, im)
    close(back / n, np.asarray(cf.irfft_packed(np_(re), np_(im), engine="pallas")) / n, tol(n))
    close(back / n, x, tol(n))
    # canonical wrappers, and the natural-order unordered forms
    close(ct.rfft(xt), ref, tol(n))
    close(ct.rfft(xt), cf.rfft(x, engine="pallas"), tol(n))
    ure, uim = ct.rfft_packed_unordered(xt)
    close(ure, re, 0.0)
    close(uim, im, 0.0)
    close(ct.irfft_unordered(ct.rfft_unordered(xt)) / n, x, tol(n))


def test_small_conv_round_trip():
    """test_pallas_engine.py's small-N conv at N = 32 (20 x tol)."""
    n = 32
    rng = np.random.default_rng(32)
    x = rng.standard_normal((4, n)).astype(np.float32)
    h = rng.standard_normal((4, n)).astype(np.float32)
    a = ct.rfft_packed_unordered(torch.from_numpy(x))
    b = ct.rfft_packed_unordered(torch.from_numpy(h))
    pr, pi = ct.convolve_accumulate_packed(a, b, scaling=1.0 / n)
    y = ct.irfft_packed_unordered(pr, pi)
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h.astype(np.float64)))
    assert np.abs(np_(y) - ref).max() < 20 * tol(n)
    # The fused entry point takes the unfused product + K5 inverse here.
    yf = ct.convolve_irfft_packed(*a, *b, scaling=1.0 / n, ordered=False)
    assert np.abs(np_(yf) - ref).max() < 20 * tol(n)


@pytest.mark.parametrize("ordered", [True, False])
def test_convolve_irfft_packed_at_k5_size_matches_jax(ordered):
    """At N = 256 (a K5 size, where the unordered layout is natural) the
    Hopper engine's fused entry point must not take K3's four-step
    permutation: it matches JAX's convolve_irfft_packed on JAX spectra."""
    n = 256
    rng = np.random.default_rng(256)
    x = rng.standard_normal((3, n)).astype(np.float32)
    h = (rng.standard_normal(n) / 16).astype(np.float32)
    fwd = cf.rfft_packed if ordered else cf.rfft_packed_unordered
    are, aim = (np.asarray(a) for a in fwd(x, engine="pallas"))
    bre, bim = (np.asarray(a)[None] for a in fwd(h, engine="pallas"))
    want = cf.convolve_irfft_packed(are, aim, bre, bim, scaling=1.0 / n, engine="pallas", ordered=ordered)
    got = hopper_fft.convolve_irfft_packed(
        *(torch.tensor(a) for a in (are, aim, bre, bim)),
        scaling=1.0 / n, ordered=ordered,
    )
    close(got, want, tol(n))
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h.astype(np.float64)), n=n)
    close(got, ref, tol(n))


def test_partitioned_fir_block_128_crosses_from_jax():
    """A PartitionedFIR with block = 128 (N = 256, a K5 size, natural
    order on both sides) carried over from JAX state keeps matching JAX;
    its spectra and FDL cross unpermuted."""
    rng = np.random.default_rng(128)
    block, taps, nblocks, split = 128, 700, 8, 4
    x = rng.standard_normal((2, nblocks * block)).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    blocks = [np.ascontiguousarray(x[:, i * block : (i + 1) * block]) for i in range(nblocks)]
    jfir = jstream.PartitionedFIR(h, block=block)
    jst = jfir.init_state((2,))
    for b in blocks[:split]:
        jst, _ = jfir.step(jst, b)
    pfir = convert.partitioned_fir_from_numpy(np.asarray(jfir.h_re), np.asarray(jfir.h_im), block, device="cpu")
    assert ct.engine_for(2 * block, "real") == "hopper"
    np.testing.assert_array_equal(np_(pfir.h_re), np.asarray(jfir.h_re))
    pst = convert.fir_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, pfir)
    np.testing.assert_array_equal(np_(pst["fdl_re"]), np.asarray(jst["fdl_re"]))
    for b in blocks[split:]:
        jst, jy = jfir.step(jst, b)
        pst, py = pfir.step(pst, torch.from_numpy(b))
        close(py, jy, 1e-3)
    # and against a fresh port filter over the whole stream
    y = pstream.partitioned_fir_apply(torch.from_numpy(x), torch.from_numpy(h), block=block)
    close(y[:, split * block :], np.asarray(jstream.partitioned_fir_apply(x, h, block=block))[:, split * block :], 1e-3)


@pytest.mark.parametrize("forward", [True, False])
def test_k5_plain_versions_match_jax(forward):
    """The three plain versions called directly."""
    n = 96
    z = rand_complex(96, (3, n))
    cplan, rplan = ct.cached_plan(n, ct.FFT_COMPLEX), ct.cached_plan(n, ct.FFT_REAL)
    want = (cf.fft if forward else cf.ifft)(z, engine="pallas")
    close(hopper_small.small_cfft_plain(torch.from_numpy(z), cplan, forward), want, tol(n))
    x = np.ascontiguousarray(z.real)
    re, im = hopper_small.small_rfft_plain(torch.from_numpy(x), rplan)
    jre, jim = cf.rfft_packed(x, engine="pallas")
    close(re, jre, tol(n))
    close(im, jim, tol(n))
    back = hopper_small.small_irfft_plain(re, im, rplan)
    close(back / n, x, tol(n))
