"""Port parity: the two-level composite (K6 complex, K7a/K7b real, through
their plain versions on the CPU) against the JAX package (its Pallas
composite in interpret mode on the CPU) and float64 numpy on the same
inputs; the composite's layout, split rule, the long-filter OLS path and
``convert`` at composite sizes.

Tolerance: 2e-7*N max abs error, the JAX package's own bound, for port vs
JAX and for either vs float64 (inverse outputs divided by N); the
cross-batch convolve uses test_pallas_engine.py's 2e-7*N*sqrt(N).
"""

import types

import numpy as np
import pytest
import scipy.signal as sig
import torch
import jax.numpy as jnp

import chowdsp_fft_tpu as cf
from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu.ops import pallas_fft
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import convert
from chowdsp_fft_tpu_torch import stream as pstream
from chowdsp_fft_tpu_torch.ops import hopper_composite as hc
from chowdsp_fft_tpu_torch.ops import hopper_fft, tables


def tol(n):
    return 2.0e-7 * n


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)


def rand_complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def packed_ref(x):
    """float64 packed planes of real rows (Nyquist in im[0])."""
    n = x.shape[-1]
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)
    re, im = spec[..., : n // 2].real.copy(), spec[..., : n // 2].imag.copy()
    im[..., 0] = spec[..., n // 2].real
    return re, im


# ---------------------------------------------------------------------------
# Complex composite (K6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("forward", [True, False])
def test_cfft_composite_matches_jax_module(forward):
    """hopper_composite.cfft_composite (the plain levels on the CPU) against
    JAX's _cfft_pair_large at N = 65536, B = 2, as test_pallas_engine.py's
    composite tests call it (dispatch uses it above 2^17)."""
    n = 65536
    assert tables.split_large(n) == pallas_fft._split_large(n) == (256, 256)
    z = rand_complex(1, (2, n))
    if not forward:
        z = np.fft.fft(z.astype(np.complex128)).astype(np.complex64)
    jr, ji = pallas_fft._cfft_pair_large(jnp.asarray(z.real), jnp.asarray(z.imag), n, forward, True)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    got = hc.cfft_composite(torch.from_numpy(z), plan, forward)
    planes = hc.cfft_composite((torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())), plan, forward)
    scale = 1.0 if forward else 1.0 / n
    close(got * scale, want * scale, tol(n))
    close(torch.complex(*planes), np_(got), 0.0)
    ref = np.fft.fft(z.astype(np.complex128)) if forward else np.fft.ifft(z.astype(np.complex128)) * n
    close(got * scale, ref * scale, tol(n))


@pytest.mark.parametrize("n", [65536, 98304, 196608])
def test_public_fft_matches_jax(n):
    """ct.fft / ifft / fft_planes on the Hopper engine (the composite above
    MAX_CN) against cf.fft(engine="pallas") (JAX's single kernel up to
    2^17, its composite above) and float64."""
    assert ct.engine_for(n, "complex") == "hopper" and n > hopper_fft.MAX_CN
    z = rand_complex(n, (2, n))
    zt = torch.from_numpy(z)
    z64 = z.astype(np.complex128)
    y = ct.fft(zt, engine="hopper")
    close(y, cf.fft(z, engine="pallas"), tol(n))
    close(y, np.fft.fft(z64), tol(n))
    b = ct.ifft(zt, engine="hopper")
    close(b / n, np.asarray(cf.ifft(z, engine="pallas")) / n, tol(n))
    close(b / n, np.fft.ifft(z64), tol(n))
    yr, yi = ct.fft_planes(zt.real.contiguous(), zt.imag.contiguous(), engine="hopper")
    close(torch.complex(yr, yi), np_(y), 0.0)
    close(ct.ifft(y, engine="hopper") / n, z, tol(n))


# ---------------------------------------------------------------------------
# Real composite (K7a, K7b, and K6 level 2)
# ---------------------------------------------------------------------------


def test_k7a_plain_matches_jax():
    """K7a's plain version against JAX's _rfft_packed_cols_impl on
    (B, A, C) = (2, 256, 256)."""
    a, c = 256, 256
    x = np.random.default_rng(7).standard_normal((2, a, c)).astype(np.float32)
    jr, ji = pallas_fft._rfft_packed_cols_impl(jnp.asarray(x), a)
    re, im = hc.rfft_cols(torch.from_numpy(x), ct.cached_plan(a, ct.FFT_REAL))
    assert re.shape == im.shape == (2, c, a // 2)
    close(re, jr, tol(a))
    close(im, ji, tol(a))
    ref_re, ref_im = packed_ref(np.swapaxes(x, 1, 2))
    close(re, ref_re, tol(a))
    close(im, ref_im, tol(a))


def test_k7b_plain_matches_jax():
    """K7b's plain version against JAX's _irfft_packed_cols_impl: (2, 256,
    128) packed planes -> (2, 256, 256), unscaled."""
    a, c = 256, 256
    x = np.random.default_rng(8).standard_normal((2, c, a))
    re, im = (p.astype(np.float32) for p in packed_ref(x))
    want = np.asarray(pallas_fft._irfft_packed_cols_impl(jnp.asarray(re), jnp.asarray(im), a))
    got = hc.irfft_cols(torch.from_numpy(re), torch.from_numpy(im), ct.cached_plan(a, ct.FFT_REAL))
    assert got.shape == (2, a, c)
    close(got / a, want / a, tol(a))
    close(got / a, np.swapaxes(x, 1, 2), tol(a))


def test_real_composite_matches_jax_module():
    """rfft_packed / irfft_packed on the Hopper engine at N = 65536 (the
    composite in the port, since N > MAX_N) against JAX's
    _rfft_direct_composite / _irfft_direct_composite, and float64."""
    n = 65536
    assert tables.split_large(n, True) == pallas_fft._split_large(n, True)
    x = np.random.default_rng(9).standard_normal((2, n)).astype(np.float32)
    re, im = ct.rfft_packed(torch.from_numpy(x), engine="hopper")
    jr, ji = pallas_fft._rfft_direct_composite(jnp.asarray(x))
    close(re, jr, tol(n))
    close(im, ji, tol(n))
    ref_re, ref_im = packed_ref(x)
    close(re, ref_re, tol(n))
    close(im, ref_im, tol(n))
    back = ct.irfft_packed(re, im, engine="hopper")
    jback = pallas_fft._irfft_direct_composite(jnp.asarray(np_(re)), jnp.asarray(np_(im)))
    close(back / n, np.asarray(jback) / n, tol(n))
    close(back / n, x, tol(n))
    # the unordered entries are the ordered ones at composite sizes
    ure, uim = ct.rfft_packed_unordered(torch.from_numpy(x), engine="hopper")
    close(ure, np_(re), 0.0)
    close(uim, np_(im), 0.0)


@pytest.mark.parametrize("n", [196608, 3 << 18])
def test_public_rfft_packed_matches_jax(n):
    """The public real path above JAX's single kernel (both packages run
    their composite) at B = 1, as test_pallas_engine.py:310-322 does:
    every bin, the Nyquist slot im[0] included, and the round trip."""
    assert ct.engine_for(n, "real") == "hopper"
    x = np.random.default_rng(n).standard_normal((1, n)).astype(np.float32)
    re, im = ct.rfft_packed(torch.from_numpy(x))
    jr, ji = map(np.asarray, cf.rfft_packed(x, engine="pallas"))
    close(re, jr, tol(n))
    close(im, ji, tol(n))
    ref_re, ref_im = packed_ref(x)
    close(re, ref_re, tol(n))
    close(im, ref_im, tol(n))
    assert abs(float(im[0, 0]) - ref_im[0, 0]) < tol(n)  # Nyquist
    back = ct.irfft_packed(re, im)
    close(back / n, x, tol(n))
    close(back / n, np.asarray(cf.irfft_packed(jr, ji, engine="pallas")) / n, tol(n))


def test_real_composite_nyquist_line():
    """A signal whose only energy is at the global Nyquist (x[t] = (-1)^t)
    and at the level-1 Nyquist line of the split (bin A/2): both land in
    their slots, and the inverse gives them back (ROADMAP bug class 3)."""
    n = 32768
    a, c = tables.split_large(n, real=True)
    t = np.arange(n)
    x = (np.where(t % 2, -1.0, 1.0) + np.cos(2 * np.pi * (a // 2) * t / n)).astype(np.float32)[None]
    re, im = ct.rfft_packed(torch.from_numpy(x))
    ref_re, ref_im = packed_ref(x)
    close(re, ref_re, tol(n))
    close(im, ref_im, tol(n))
    assert abs(float(im[0, 0]) - n) < tol(n)
    close(ct.irfft_packed(re, im) / n, x, tol(n))


# ---------------------------------------------------------------------------
# Layout: natural order at every batch
# ---------------------------------------------------------------------------


def test_composite_unordered_layout_is_natural_at_every_batch():
    """test_pallas_engine.py:554-587 on the port, without the block-size
    monkeypatch (no batch gate exists here): fft_unordered at a composite
    size is natural order, the same at B = 1 and B = 5, and a filter
    spectrum taken at batch 1 convolves with a batch of 5."""
    n = 196608
    x = rand_complex(11, (5, n))
    h = rand_complex(12, (1, n))
    xs = ct.fft_unordered(torch.from_numpy(x))
    hs = ct.fft_unordered(torch.from_numpy(h))
    ref_x = np.fft.fft(x.astype(np.complex128))
    ref_h = np.fft.fft(h.astype(np.complex128))
    close(xs, ref_x, tol(n))
    close(hs, ref_h, tol(n))
    close(ct.fft_unordered(torch.from_numpy(x[2:3])), np_(xs)[2:3], 0.0)
    yr, yi = ct.fft_planes_unordered(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    close(torch.complex(yr, yi), np_(xs), 0.0)
    got = ct.ifft_unordered(ct.convolve_accumulate(xs, hs)) / n
    ref = np.fft.ifft(ref_x * ref_h)
    close(got, ref, tol(n) * np.sqrt(n))


# ---------------------------------------------------------------------------
# The split rule
# ---------------------------------------------------------------------------


def smooth_sizes(limit):
    """Every {2,3,5}-smooth N in [8, limit]."""
    out = []
    p2 = 1
    while p2 <= limit:
        p3 = p2
        while p3 <= limit:
            p5 = p3
            while p5 <= limit:
                if p5 >= 8:
                    out.append(p5)
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return sorted(out)


def test_split_large_follows_jax():
    """The port's copy of _split_large equals JAX's wherever JAX has a
    split; the port's split equals JAX's on every size where JAX runs its
    v2 composite; every size the port's composite serves has a split the
    column kernel holds, even/even for every real size."""
    for kind in ("complex", "real"):
        real = kind == "real"
        for n in smooth_sizes(1 << 20):
            if real and n % 2:
                continue
            try:
                want = pallas_fft._split_large(n, real)
            except pallas_fft.InvalidSizeError:
                want = None
            if want is None:
                with pytest.raises(ct.InvalidSizeError):
                    tables.jax_split_large(n, real)
            else:
                assert tables.jax_split_large(n, real) == want, (n, kind)
            jax_composite = not pallas_fft._small_dispatch(n) and (
                n > pallas_fft._MAX_N or not pallas_fft._is_smooth_multiple(n))
            v2 = pallas_fft._rdc_batch_cap(n) if real else pallas_fft._v2_batch_cap(n)
            if want is not None and jax_composite and v2:
                assert tables.split_large(n, real) == want, (n, kind)
            single = hopper_fft._in_domain(n) if real else hc.hopper_cfft.in_domain(n)
            stub = types.SimpleNamespace(n=n, kind=kind)
            if hopper_fft.supports_plan(stub) and not tables.jax_small_dispatch(n) and not single:
                a, c = tables.split_large(n, real)
                assert a * c == n and 8 <= c <= a <= hc.MAX_COL, (n, kind, a, c)
                if real:
                    assert a % 2 == 0 and c % 2 == 0, (n, a, c)


def test_composite_tables_match_jax():
    """The four-step tables are JAX's own float32 values."""
    n = 65536
    for forward in (True, False):
        for got, want in zip(tables.large_twiddle(n, forward), pallas_fft._large_twiddle(n, forward, folded=False)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(tables.rdc_l2_twiddle(n, forward), pallas_fft._rdc_l2_twiddle(n, forward)):
            np.testing.assert_array_equal(got, want)
    _, _, _, nyt = pallas_fft._direct_real_tables(n)
    for got, want in zip(tables.nyquist_twiddle(n), nyt):
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1))


def test_levels_compose_at_an_uneven_split():
    """K6's four roles (their plain versions on the CPU) at a split with
    A != C and an odd batch: level 1 stores (B, C, A), level 2 gives the
    natural-order spectrum, and level-2 reverse then level-1 reverse give
    N times the input back, in both complex forms."""
    n, rows = 20480, 3
    a, c = tables.split_large(n)
    assert (a, c) == (160, 128)
    pa, pc = ct.cached_plan(a, ct.FFT_COMPLEX), ct.cached_plan(c, ct.FFT_COMPLEX)
    z = rand_complex(20480, (rows, n))
    for x in (torch.from_numpy(z), (torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()))):
        mid = hc.level1(hc._view(x, (rows, a, c)), pa, True)
        assert hc.as_complex(mid).shape == (rows, c, a)
        y = hc.level2(mid, hc.twiddle(n, True, "cpu"), pc, True)
        close(hc.as_complex(y).reshape(rows, n), np.fft.fft(z.astype(np.complex128)), tol(n))
        back_mid = hc.level2(hc._view(y, (rows, c, a)), hc.twiddle(n, False, "cpu"), pc, False)
        back = hc.level1(back_mid, pa, False)
        assert hc.as_complex(back).shape == (rows, a, c)
        close(hc.as_complex(back).reshape(rows, n) / n, z, tol(n))


# ---------------------------------------------------------------------------
# The long-filter OLS path and convert
# ---------------------------------------------------------------------------


def test_long_filter_ols_runs_composite_and_matches_jax():
    """fir_filter_ols with a 6000-tap filter picks N = 2^15, a composite
    size in the port (JAX's single kernel): against JAX's fir_filter_ols
    and a float64 lfilter at test_stream.py's atol 5e-4."""
    rng = np.random.default_rng(6000)
    taps, t = 6000, 40000
    x = rng.standard_normal((2, t)).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    assert pstream.next_fft_size(max(256, pstream.next_fft_size(4 * taps) // 2) + taps - 1) == 1 << 15
    assert not hopper_fft._in_domain(1 << 15) and hopper_fft.supports_plan(ct.cached_plan(1 << 15, "real"))
    y = np_(pstream.fir_filter_ols(torch.from_numpy(x), torch.from_numpy(h)))
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(jstream.fir_filter_ols(x, h)), atol=5e-4, rtol=0)
    ref = sig.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(y, ref, atol=5e-4, rtol=0)


def test_jax_v2_composite_spectrum_crosses():
    """A JAX v2 composite spectrum (N = 147456 = 384 x 384, natural order)
    crosses into the port unchanged and inverts there; a v1 one (576 under
    engine="pallas", 24 x 24) is refused."""
    n = 147456
    assert tables.jax_cfft_composite_is_natural(n) and pallas_fft._v2_batch_cap(n) > 0
    z = rand_complex(n, (1, n))
    spec = np.asarray(cf.fft_unordered(z))
    pt = convert.cfft_unordered_from_numpy(spec, device="cpu")
    np.testing.assert_array_equal(np_(pt), spec)
    close(ct.ifft_unordered(pt) / n, z, tol(n))
    assert not tables.jax_cfft_composite_is_natural(576)
    with pytest.raises(ValueError, match="v1"):
        convert.cfft_unordered_from_numpy(np.zeros((1, 576), np.complex64), src_engine="pallas", device="cpu")


def test_jax_cfft_composite_is_natural_follows_jax():
    for n in (576, 960, 147456, 186624, 196608, 1 << 18, 279936, 3 << 18, 1 << 20):
        assert tables.jax_cfft_composite_is_natural(n) == (pallas_fft._v2_batch_cap(n) > 0), n


# ---------------------------------------------------------------------------
# The dispatch matrix (test_pallas_engine.py:685 on the port)
# ---------------------------------------------------------------------------

_NAMES = {"pallas": "hopper", "stockham": "stockham"}


def _auto(engines, order, plan):
    return next(name for name in order if engines[name]["prefers"](plan))


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_dispatch_matrix_matches_jax(kind):
    """For every valid N <= 2^20, the Hopper engine serves exactly what the
    JAX pallas engine serves, and auto picks the engine JAX's auto picks
    (names mapped). The sweep asks both registries' predicates on a
    plan-shaped stub (building ~500 plans of up to 2^20 points would cost
    minutes and gigabytes); the public calls are checked on the regime
    boundaries below."""
    from chowdsp_fft_tpu import api as japi
    from chowdsp_fft_tpu_torch import api as papi

    for n in smooth_sizes(1 << 20):
        if kind == "real" and n % 2:
            continue
        stub = types.SimpleNamespace(n=n, kind=kind, cfft_n=n)
        assert papi._ENGINES["hopper"]["supports"](stub) == japi._ENGINES["pallas"]["supports"](stub), (n, kind)
        want = _NAMES[_auto(japi._ENGINES, ("pallas", "stockham"), stub)]
        assert _auto(papi._ENGINES, ("hopper", "stockham"), stub) == want, (n, kind)


BOUNDARY = [8, 256, 384, 480, 512, 576, 640, 960, 1458, 13824, 16384, 20480, 32768, 1 << 17,
            147456, 186624, 196608, 1 << 18, 279936, 3 << 18, 1 << 20, 1 << 21]


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_dispatch_boundaries_public(kind):
    """engine_supports / engine_for through the public api at the regime
    boundaries: K5, K1-K4, the composite above MAX_N / MAX_CN, the medium
    smooth sizes (served on request, auto takes Stockham), the sizes
    without a split (real 1458, 279936) and above 2^20."""
    for n in BOUNDARY:
        if not ct.is_valid_size(n, kind):
            continue
        assert ct.engine_supports("hopper", n, kind) == cf.engine_supports("pallas", n, kind), (n, kind)
        assert ct.engine_for(n, kind) == _NAMES[cf.engine_for(n, kind)], (n, kind)
    assert ct.engine_for(1 << 20, kind) == "hopper"
    assert ct.engine_for(576, kind) == "stockham" and ct.engine_supports("hopper", 576, kind)
    assert ct.engine_supports("hopper", 1458, kind) == (kind == "complex")
