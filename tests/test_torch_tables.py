"""Port parity: plans, kernel tables, the unordered layout, layout
converters and the packed convolve, each held against the JAX package on
the same numpy inputs (JAX on the CPU, as its own tests run it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu import plans as jax_plans
from chowdsp_fft_tpu.ops import convolve as jax_convolve
from chowdsp_fft_tpu.ops import layout as jax_layout
from chowdsp_fft_tpu.utils import native as jax_native
from chowdsp_fft_tpu_torch import convert
from chowdsp_fft_tpu_torch.ops import convolve as pt_convolve
from chowdsp_fft_tpu_torch.ops import layout as pt_layout
from chowdsp_fft_tpu_torch.ops import tables
from chowdsp_fft_tpu_torch.utils import native as pt_native

# A plan's tables come from the native long-double planner or, without
# g++, from float64 numpy: the two differ only below one float32 ulp of 1.
TABLE_ATOL = 2.0**-24


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_factorize_and_valid_size_parity():
    for n in range(2, 5001):
        for kind in ("real", "complex"):
            assert ct.is_valid_size(n, kind) == cf.is_valid_size(n, kind), (n, kind)
        try:
            want = cf.factorize(n)
        except cf.InvalidSizeError:
            with pytest.raises(ct.InvalidSizeError):
                ct.factorize(n)
        else:
            assert ct.factorize(n) == want, n
    with pytest.raises(ct.InvalidSizeError):
        ct.make_plan(7 * 128, ct.FFT_REAL)
    with pytest.raises(ct.InvalidSizeError):
        ct.make_plan(1, ct.FFT_COMPLEX)
    assert issubclass(ct.InvalidSizeError, ValueError)
    with pytest.raises(ValueError):
        ct.make_plan(64, "bogus")


def _perm_from_jax(n, rows):
    """Read the unordered permutation off the JAX kernel's output: the bin
    whose ordered value each unordered position holds."""
    rng = np.random.default_rng(n + rows)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    ore, oim = (np.asarray(a) for a in cf.rfft_packed(x, engine="pallas"))
    ure, uim = (np.asarray(a) for a in cf.rfft_packed_unordered(x, engine="pallas"))
    ordered = ore + 1j * oim
    unordered = ure + 1j * uim
    dist = np.abs(unordered[:, :, None] - ordered[:, None, :]).sum(axis=0)
    return np.argmin(dist, axis=1)


@pytest.mark.parametrize("n", [384, 1024, 1536, 4096])
def test_unordered_perm_is_jax_layout(n):
    perm = tables.unordered_perm(n)
    assert perm.dtype == np.int32 and perm.shape == (n // 2,) and perm[0] == 0
    np.testing.assert_array_equal(np.sort(perm), np.arange(n // 2))
    np.testing.assert_array_equal(perm[tables.inverse_perm(n)], np.arange(n // 2))
    # The JAX layout, independent of the batch size.
    np.testing.assert_array_equal(_perm_from_jax(n, 1), perm)
    np.testing.assert_array_equal(_perm_from_jax(n, 3), perm)


@pytest.mark.parametrize("n", [384, 640, 1024, 1920, 4096, 16384])
def test_kernel_tables_match_jax(n):
    """The tables the kernels read: the real plan's Stockham stage tables
    (half-length complex transform) and its split twiddles. With g++ the
    port takes them from its native planner, bit-equal to the planner's
    float64 tables cast to float32, and to the JAX plan's where the JAX
    package's planner loaded too (one source); without g++, bit-equal to
    the JAX package's float64-numpy construction."""
    mine = ct.make_plan(n, ct.FFT_REAL)
    ref = cf.make_plan(n, cf.FFT_REAL)
    assert mine.radices == tuple(ref.radices)
    assert len(mine.stages) == len(ref.stages)
    if pt_native.available():
        want_stages = [(re.astype(np.float32), im.astype(np.float32)) for re, im in pt_native.stage_twiddles(n // 2)]
        want_split = tuple(t.astype(np.float32) for t in pt_native.rfft_twiddles(n))
    else:
        want_stages = [jax_plans._stage_twiddle_np(st.radix * st.m, st.radix) for st in mine.stages]
        k = np.arange(n // 2, dtype=np.float64)
        want_split = (np.cos(-2.0 * np.pi * k / n).astype(np.float32), np.sin(-2.0 * np.pi * k / n).astype(np.float32))
    jax_exact = pt_native.available() and jax_native.get_lib() is not None
    for a, b, (want_re, want_im) in zip(mine.stages, ref.stages, want_stages, strict=True):
        assert (a.radix, a.m, a.s) == (b.radix, b.m, b.s)
        assert a.tw_re.dtype == np.float32 and a.tw_re.shape == (a.radix, a.m)
        np.testing.assert_array_equal(a.tw_re, want_re)
        np.testing.assert_array_equal(a.tw_im, want_im)
        # ... and to the JAX plan's own tables: bit-equal, or within TABLE_ATOL.
        for got, jax_t in ((a.tw_re, b.tw_re), (a.tw_im, b.tw_im)):
            if jax_exact:
                np.testing.assert_array_equal(got, np.asarray(jax_t))
            else:
                np.testing.assert_allclose(got, np.asarray(jax_t), atol=TABLE_ATOL, rtol=0)
    np.testing.assert_array_equal(mine.rfft_tw_re, want_split[0])
    np.testing.assert_array_equal(mine.rfft_tw_im, want_split[1])
    for got, jax_t in ((mine.rfft_tw_re, ref.rfft_tw_re), (mine.rfft_tw_im, ref.rfft_tw_im)):
        if jax_exact:
            np.testing.assert_array_equal(got, np.asarray(jax_t))
        else:
            np.testing.assert_allclose(got, np.asarray(jax_t), atol=TABLE_ATOL, rtol=0)
    # The flat table the kernels read is the stage tables in stage order.
    dev = mine.device_tables("cpu")
    flat = np.concatenate([(st.tw_re + 1j * st.tw_im).ravel() for st in mine.stages])
    np.testing.assert_array_equal(np_(dev.stage_flat), flat.astype(np.complex64))
    np.testing.assert_array_equal(np_(dev.split_tw).real, mine.rfft_tw_re)


def test_plan_from_numpy_round_trip(rng):
    n = 1024
    ref = cf.make_plan(n, cf.FFT_REAL)
    plan = convert.plan_from_numpy(
        n,
        "real",
        [(np.asarray(st.tw_re), np.asarray(st.tw_im)) for st in ref.stages],
        (np.asarray(ref.rfft_tw_re), np.asarray(ref.rfft_tw_im)),
    )
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    got = ct.rfft_packed(x, plan=plan)
    want = cf.rfft_packed(np_(x), plan=ref, engine="stockham")
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=2e-7 * n, rtol=0)
    with pytest.raises(ValueError):
        convert.plan_from_numpy(n, "real", [], None)


def test_layout_converters_match_jax(rng):
    n = 64
    spec = (rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))).astype(np.complex64)
    spec[:, 0] = spec[:, 0].real
    spec[:, -1] = spec[:, -1].real
    st = torch.from_numpy(spec)
    for g, w in zip(pt_layout.spectrum_to_packed_planes(st), jax_layout.spectrum_to_packed_planes(spec)):
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    re, im = (np.array(a) for a in jax_layout.spectrum_to_packed_planes(spec))
    np.testing.assert_array_equal(
        np_(pt_layout.packed_planes_to_spectrum(torch.from_numpy(re), torch.from_numpy(im))),
        np.asarray(jax_layout.packed_planes_to_spectrum(re, im)),
    )
    packed = np_(pt_layout.to_packed_real_spectrum(st))
    np.testing.assert_array_equal(packed, np.asarray(jax_layout.to_packed_real_spectrum(spec)))
    np.testing.assert_array_equal(
        np_(pt_layout.from_packed_real_spectrum(torch.from_numpy(packed))),
        np.asarray(jax_layout.from_packed_real_spectrum(packed)),
    )
    z = torch.from_numpy(spec)
    inter = np_(pt_layout.interleave_complex(z))
    np.testing.assert_array_equal(inter, np.asarray(jax_layout.interleave_complex(spec)))
    np.testing.assert_array_equal(
        np_(pt_layout.deinterleave_complex(torch.from_numpy(inter))),
        np.asarray(jax_layout.deinterleave_complex(inter)),
    )


@pytest.mark.parametrize("b_shape", [(3, 32), (32,)])
@pytest.mark.parametrize("scaling", [1.0, 0.25])
@pytest.mark.parametrize("with_ab", [False, True])
def test_convolve_accumulate_packed_matches_jax(rng, b_shape, scaling, with_ab):
    """Includes the bin-0 patch-up: re[0] = DC*DC, im[0] = Nyq*Nyq."""
    a = [rng.standard_normal((3, 32)).astype(np.float32) for _ in range(2)]
    b = [rng.standard_normal(b_shape).astype(np.float32) for _ in range(2)]
    ab = [rng.standard_normal((3, 32)).astype(np.float32) for _ in range(2)] if with_ab else None
    t = lambda v: None if v is None else tuple(torch.from_numpy(x) for x in v)  # noqa: E731
    got = pt_convolve.convolve_accumulate_packed(t(a), t(b), ab=t(ab), scaling=scaling)
    want = jax_convolve.convolve_accumulate_packed(tuple(a), tuple(b), ab=None if ab is None else tuple(ab), scaling=scaling)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-6, atol=1e-6)
    dc = a[0][:, 0] * np.broadcast_to(b[0], (3, 32))[:, 0] * scaling
    nyq = a[1][:, 0] * np.broadcast_to(b[1], (3, 32))[:, 0] * scaling
    off = (ab[0][:, 0], ab[1][:, 0]) if with_ab else (0.0, 0.0)
    np.testing.assert_allclose(np_(got[0])[:, 0], dc + off[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(got[1])[:, 0], nyq + off[1], rtol=1e-6, atol=1e-6)


def test_convolve_accumulate_and_accumulate_match_jax(rng):
    a = (rng.standard_normal((2, 17)) + 1j * rng.standard_normal((2, 17))).astype(np.complex64)
    b = (rng.standard_normal((2, 17)) + 1j * rng.standard_normal((2, 17))).astype(np.complex64)
    ab = (rng.standard_normal((2, 17)) + 1j * rng.standard_normal((2, 17))).astype(np.complex64)
    ta, tb, tab = (torch.from_numpy(v) for v in (a, b, ab))
    np.testing.assert_allclose(
        np_(pt_convolve.convolve_accumulate(ta, tb, tab, scaling=0.5)),
        np.asarray(jax_convolve.convolve_accumulate(a, b, ab, scaling=0.5)),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        np_(ct.multiply_spectra(ta, tb, scaling=2.0)),
        np.asarray(cf.multiply_spectra(a, b, scaling=2.0)),
        rtol=1e-6, atol=1e-6,
    )
    x = rng.standard_normal((3, 100)).astype(np.float32)
    y = rng.standard_normal((3, 100)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(ct.accumulate(torch.from_numpy(x), torch.from_numpy(y))),
        np.asarray(cf.accumulate(jnp.asarray(x), jnp.asarray(y))),
    )
