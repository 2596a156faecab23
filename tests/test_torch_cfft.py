"""Port parity: the complex transform surface at K4 sizes (the complex
Stockham kernel, through its plain version on the CPU), held against the
JAX package (its Pallas engine in interpret mode on the CPU) and float64
numpy on the same inputs.

Tolerance: 2e-7*N max abs error, the JAX package's own bound, for port vs
JAX and for either vs float64; the unordered conv round trip uses
test_pallas_engine.py's 2e-7*N*sqrt(N).
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import convert
from chowdsp_fft_tpu_torch.ops import hopper_cfft, tables

SIZES = [384, 640, 1024, 1920]
LEADS = [(3,), (2, 3)]


def tol(n):
    return 2.0e-7 * n


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=0)


def rand_complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("n", SIZES)
def test_fft_ifft_match_jax(n, lead):
    """Forward/backward x ordered/unordered on complex64, against JAX and
    float64, and the round trips (unscaled: ifft(fft(x)) == N x)."""
    assert ct.engine_for(n, "complex") == "hopper"
    z = rand_complex(n, (*lead, n))
    zt = torch.from_numpy(z)
    z64 = z.astype(np.complex128)
    perm = tables.cfft_unordered_perm(n)

    y = ct.fft(zt)
    assert y.shape == zt.shape and y.dtype == torch.complex64
    close(y, cf.fft(z, engine="pallas"), tol(n))
    close(y, np.fft.fft(z64), tol(n))
    b = ct.ifft(zt)
    close(b, cf.ifft(z, engine="pallas"), tol(n))
    close(b, np.fft.ifft(z64) * n, tol(n))

    yu = ct.fft_unordered(zt)
    close(yu, cf.fft_unordered(z, engine="pallas"), tol(n))
    close(yu, np.fft.fft(z64)[..., perm], tol(n))
    bu = ct.ifft_unordered(zt)
    close(bu, cf.ifft_unordered(z, engine="pallas"), tol(n))

    close(ct.ifft(y) / n, z, tol(n))
    close(ct.ifft_unordered(yu) / n, z, tol(n))


@pytest.mark.parametrize("n", SIZES)
def test_fft_planes_match_jax(n):
    """The SoA planes forms, ordered and unordered, both directions."""
    z = rand_complex(n + 1, (3, n))
    re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    rt, it = torch.from_numpy(re), torch.from_numpy(im)
    pairs = [
        (ct.fft_planes, cf.fft_planes),
        (ct.ifft_planes, cf.ifft_planes),
        (ct.fft_planes_unordered, cf.fft_planes_unordered),
        (ct.ifft_planes_unordered, cf.ifft_planes_unordered),
    ]
    for port, jax_fn in pairs:
        got = port(rt, it)
        want = jax_fn(re, im, engine="pallas")
        for g, w in zip(got, want):
            assert g.shape == (3, n) and g.dtype == torch.float32
            close(g, w, tol(n))
    # planes and complex64 give the same result
    yr, yi = ct.fft_planes_unordered(rt, it)
    close(torch.complex(yr, yi), ct.fft_unordered(torch.from_numpy(z)), 0.0)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_unordered_layout_is_jax_and_batch_independent(n, batch):
    """The unordered layout reads back off JAX's fft_unordered as
    cfft_unordered_perm (k1*128 + k2 holds bin k1 + N1*k2), the same at
    batch 1 and 3, and is not the real layout (k1*64 + k2)."""
    z = rand_complex(n + 2, (batch, n))
    ordered = np.asarray(cf.fft(z, engine="pallas"))
    unordered = np.asarray(cf.fft_unordered(z, engine="pallas"))
    perm = tables.cfft_unordered_perm(n)
    np.testing.assert_allclose(unordered, ordered[:, perm], atol=1e-4 * np.sqrt(n), rtol=0)
    close(ct.fft_unordered(torch.from_numpy(z)), unordered, tol(n))
    assert not np.array_equal(perm[: n // 2], tables.unordered_perm(n))


def test_complex_unordered_conv_round_trip():
    """test_pallas_engine.py:122 on the port: unordered spectra, an
    order-independent product, the unordered inverse."""
    n = 1024
    a, b = rand_complex(1, (n,)), rand_complex(2, (n,))
    A = ct.fft_unordered(torch.from_numpy(a))
    B = ct.fft_unordered(torch.from_numpy(b))
    y = ct.ifft_unordered(ct.convolve_accumulate(A, B)) / n
    ref = np.fft.ifft(np.fft.fft(a.astype(np.complex128)) * np.fft.fft(b.astype(np.complex128)))
    close(y, ref, tol(n) * np.sqrt(n))
    jy = np.asarray(cf.ifft_unordered(cf.convolve_accumulate(
        cf.fft_unordered(a, engine="pallas"), cf.fft_unordered(b, engine="pallas")), engine="pallas")) / n
    close(y, jy, tol(n) * np.sqrt(n))


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("forward", [True, False])
def test_k4_plain_version_matches_jax(forward, ordered):
    """K4's plain version called directly, on both input forms."""
    n = 640
    z = rand_complex(7, (3, n))
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    want = {
        (True, True): cf.fft, (False, True): cf.ifft,
        (True, False): cf.fft_unordered, (False, False): cf.ifft_unordered,
    }[(forward, ordered)](z, engine="pallas")
    got = hopper_cfft.cfft_kernel(torch.from_numpy(z), plan, forward, ordered)
    close(got, want, tol(n))
    re, im = torch.from_numpy(np.ascontiguousarray(z.real)), torch.from_numpy(np.ascontiguousarray(z.imag))
    gr, gi = hopper_cfft.cfft_plain((re, im), plan, forward, ordered)
    close(torch.complex(gr, gi), want, tol(n))


@pytest.mark.parametrize("n,engine", [(1024, "auto"), (1024, "stockham"), (256, "auto"), (16384, "auto")])
def test_cfft_unordered_spectrum_crosses_from_jax(n, engine):
    """A JAX fft_unordered spectrum carried into the port's layout inverts
    through the port's ifft_unordered: K4 sizes keep JAX's permutation,
    the Stockham engine and K5 sizes are natural, and N = 16384 (JAX
    kernel, port Stockham) is reordered."""
    z = rand_complex(n + 5, (2, n))
    spec = np.asarray(cf.fft_unordered(z, engine="pallas" if n <= 4096 else "auto"))
    pt = convert.cfft_unordered_from_numpy(spec, engine=engine, device="cpu")
    back = ct.ifft_unordered(pt, engine=engine) / n
    close(back, z, tol(n))
    if n == 1024 and engine == "auto":
        np.testing.assert_array_equal(np_(pt), spec)


def test_cfft_unordered_from_jax_composite_is_refused():
    """At N = 576 JAX's auto engine is its Stockham engine (natural order,
    carried over), but an explicit engine="pallas" runs the v1 two-level
    composite (split 24 x 24), whose unordered layout is neither natural
    nor the kernel permutation: converting it is refused instead of
    mis-ordered. So is N = 186624 (split 432 x 432, v1) under auto."""
    n = 576
    z = rand_complex(n + 6, (2, n))
    natural = np.fft.fft(z.astype(np.complex128))
    spec = np.asarray(cf.fft_unordered(z, engine="auto"))
    close(spec, natural, tol(n))
    back = ct.ifft_unordered(convert.cfft_unordered_from_numpy(spec, device="cpu")) / n
    close(back, z, tol(n))

    pallas_spec = np.asarray(cf.fft_unordered(z, engine="pallas"))
    assert np.abs(pallas_spec - natural).max() > 1.0  # the composite's own layout
    with pytest.raises(ValueError, match="composite"):
        convert.cfft_unordered_from_numpy(pallas_spec, src_engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="composite"):
        convert.cfft_unordered_from_numpy(np.zeros((1, 186624), np.complex64), device="cpu")


def test_jax_cfft_is_composite_follows_jax_dispatch():
    """convert.jax_cfft_is_composite agrees with the JAX package's own
    dispatch predicates (engine choice, small-N, single-kernel domain)."""
    from chowdsp_fft_tpu.ops import pallas_fft

    sizes = [8, 200, 256, 384, 480, 512, 576, 960, 1024, 13824, 16384, 1 << 17,
             1 << 18, 186624, 194400]
    for n in sizes:
        for engine in ("auto", "pallas", "stockham"):
            name = cf.engine_for(n, "complex") if engine == "auto" else engine
            want = (name == "pallas" and not pallas_fft._small_dispatch(n)
                    and not (n <= pallas_fft._MAX_N and pallas_fft._is_smooth_multiple(n)))
            assert convert.jax_cfft_is_composite(n, engine) == want, (n, engine)
