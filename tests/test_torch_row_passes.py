"""K1 and K4's row engine (``csrc/row_passes.cuh``) on the CPU: the launch
geometry (``ops/row_passes.launch_geometry``) at every size of both
domains, and a numpy model of the engine's passes (the same pass plan,
Stockham indexing, float32 inner roots and root table as the kernels)
against float64 at every size, ordered and unordered, with K1's split.
The kernels themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py)."""

import pathlib
import re

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import hopper_cfft, hopper_fft, row_passes, tables

CSRC = pathlib.Path(ct.__file__).parent / "csrc"
REAL_SIZES = [n for n in range(257, hopper_fft.MAX_N + 1) if hopper_fft._in_domain(n)]
COMPLEX_SIZES = [n for n in range(257, hopper_cfft.MAX_CN + 1) if hopper_cfft.in_domain(n)]
CASES = [(n, ct.FFT_REAL) for n in REAL_SIZES] + [(n, ct.FFT_COMPLEX) for n in COMPLEX_SIZES]


def test_domains_are_the_kernels():
    assert len(REAL_SIZES) == 36 and REAL_SIZES[0] == 384 and REAL_SIZES[-1] == 16384
    assert len(COMPLEX_SIZES) == 33 and COMPLEX_SIZES[-1] == 13824


def test_points_per_thread_is_the_sources():
    """Python's constants are the ones the kernels are built with (the
    library reports kRowPoints on the card: chip_smoke phase 1)."""
    src = (CSRC / "row_passes.cuh").read_text()
    assert int(re.search(r"constexpr int kRowPoints = (\d+);", src).group(1)) == row_passes.POINTS_PER_THREAD
    stockham = (CSRC / "stockham.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxSmemBytes = (\d+);", stockham).group(1)) == row_passes.SMEM_LIMIT


@pytest.mark.parametrize("n,kind", CASES)
def test_geometry_at_every_size(n, kind):
    """The pass plan fuses the plan's stages in order and multiplies out to
    L; the threads cover every row with 16 points a thread; a block fits."""
    plan = ct.cached_plan(n, kind)
    L = row_passes.row_points(plan)
    for rows in (1, 7, 1000, 7552):
        g = row_passes.launch_geometry(plan, rows)
        stages = [r for pair in g.passes for r in pair if r != 1]
        assert tuple(stages) == plan.radices
        assert all(r1 != 1 for _, r1 in g.passes[:-1])  # pairs, a lone stage only at the end
        assert int(np.prod([r0 * r1 for r0, r1 in g.passes])) == L
        assert g.threads_per_row * row_passes.POINTS_PER_THREAD == L
        assert g.threads == g.rows_per_block * g.threads_per_row <= 1024
        assert g.threads >= min(row_passes.MIN_BLOCK_THREADS, g.threads_per_row)
        assert g.smem_bytes == g.rows_per_block * 2 * (L + L // 32) * 8 <= row_passes.SMEM_LIMIT
        assert (g.grid - 1) * g.rows_per_block < rows <= g.grid * g.rows_per_block
        assert len(g.flat_passes) == 2 * len(g.passes)


def _inner(q: int) -> np.ndarray:
    """The kernels' inner roots: exp(-2i*pi*e/q) in float32."""
    e = np.arange(q)
    return np.exp(-2j * np.pi * e / q).astype(np.complex64)


def _dft(v: np.ndarray, r: int) -> np.ndarray:
    """Radix-r butterflies along axis 1 (float32 roots, as stockham.cuh's)."""
    w = _inner(r)[(np.arange(r)[:, None] * np.arange(r)[None, :]) % r]
    return np.einsum("jk,bk...->bj...", w, v).astype(np.complex64)


def engine_model(x: np.ndarray, plan) -> np.ndarray:
    """The row engine's forward transform of (rows, L) complex64 rows, pass
    by pass as row_passes.cuh computes it: a pass of radix P = R0*R1 at
    stride s reads x[k*(L/P) + u] (u = p*s + q), runs the R0-point stage
    with inner twiddles W_P^(j*p'), then the R1-point stage, multiplies
    output j by the pass table's W_L^(j*p*s) (at [j*m + p]) and writes
    x[p*P*s + j*s + q]."""
    L = x.shape[-1]
    rows = x.shape[0]
    table = row_passes.pass_twiddles(plan.radices, L)
    s = 1
    for r0, r1 in row_passes.pass_plan(plan.radices):
        P = r0 * r1
        m = L // (P * s)
        v = x.reshape(rows, r0, r1, m, s)  # k = k0*R1 + p', then (p, q)
        v = _dft(v, r0)  # over k0: (rows, j0, p', m, s)
        if r1 > 1:
            v = v * _inner(P)[(np.arange(r0)[:, None] * np.arange(r1)[None, :])][None, :, :, None, None]
            v = _dft(np.swapaxes(v, 1, 2), r1)  # over p': (rows, j1, j0, m, s); output j = j1*R0 + j0
        v = v.reshape(rows, P, m, s)
        tw, table = table[: P * m].reshape(P, m), table[P * m :]
        v = (v * tw[None, :, :, None]).astype(np.complex64)
        x = np.ascontiguousarray(np.transpose(v, (0, 2, 1, 3))).reshape(rows, L)
        s *= P
    return x


@pytest.mark.parametrize("kind", [ct.FFT_REAL, ct.FFT_COMPLEX])
def test_engine_model_matches_float64(kind):
    """At every size: the pass model within 2e-7*N of numpy float64, the
    complex transform ordered and unordered, the real one through K1's
    split into packed planes, ordered and in the JAX unordered layout."""
    rng = np.random.default_rng(6)
    sizes = REAL_SIZES if kind == ct.FFT_REAL else COMPLEX_SIZES
    for n in sizes:
        plan = ct.cached_plan(n, kind)
        rows = 3
        if kind == ct.FFT_COMPLEX:
            z = (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            want = np.fft.fft(z.astype(np.complex128), axis=-1)
            got = engine_model(z, plan)
            assert np.abs(got - want).max() <= 2e-7 * n, n
            perm = tables.cfft_unordered_perm(n)
            assert np.abs(got[:, perm] - want[:, perm]).max() <= 2e-7 * n, n
            continue
        x = rng.standard_normal((rows, n)).astype(np.float32)
        m = n // 2
        zz = engine_model(np.ascontiguousarray(x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64), plan)
        k = np.arange(1, m)
        zc = np.conj(zz[:, m - k])
        e, o = (zz[:, k] + zc) / 2, -0.5j * (zz[:, k] - zc)
        w = (plan.rfft_tw_re + 1j * plan.rfft_tw_im)[k]
        xk = e + w * o
        re = np.concatenate([(zz[:, :1].real + zz[:, :1].imag), xk.real], -1)
        im = np.concatenate([(zz[:, :1].real - zz[:, :1].imag), xk.imag], -1)
        spec = np.fft.rfft(x.astype(np.float64), axis=-1)
        want_re, want_im = spec[:, :m].real.copy(), spec[:, :m].imag.copy()
        want_im[:, 0] = spec[:, m].real
        for sel in (slice(None), tables.unordered_perm(n)):
            err = max(np.abs(re[:, sel] - want_re[:, sel]).max(), np.abs(im[:, sel] - want_im[:, sel]).max())
            assert err <= 2e-7 * n, n


@pytest.mark.parametrize("n,kind", [(384, ct.FFT_REAL), (4096, ct.FFT_COMPLEX), (13824, ct.FFT_COMPLEX)])
def test_pass_twiddles_are_float64_roots(n, kind):
    """Each pass's table holds W_L^(j*p*s) at [j*m + p], rounded once from
    float64; the real plan's unordered split table is the plan's split
    table in the unordered layout."""
    plan = ct.cached_plan(n, kind)
    L = row_passes.row_points(plan)
    table = row_passes.pass_twiddles(plan.radices, L)
    s, off = 1, 0
    for r0, r1 in row_passes.pass_plan(plan.radices):
        P = r0 * r1
        m = L // (P * s)
        j, p = np.meshgrid(np.arange(P), np.arange(m), indexing="ij")
        want = np.exp(-2j * np.pi * ((j * p * s) % L) / L)
        np.testing.assert_array_equal(table[off : off + P * m].reshape(P, m), want.astype(np.complex64))
        off, s = off + P * m, s * P
    assert off == table.size
    tw, split = row_passes.device_tables(n, kind, "cpu")
    assert torch.equal(tw, torch.from_numpy(table))
    if kind == ct.FFT_REAL:
        perm = tables.unordered_perm(n)
        np.testing.assert_array_equal(split.real.numpy(), plan.rfft_tw_re[perm])
        np.testing.assert_array_equal(split.imag.numpy(), plan.rfft_tw_im[perm])
    else:
        assert split is None


def test_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        row_passes.launch_geometry(ct.cached_plan(1 << 15, ct.FFT_COMPLEX), 1)  # 1 MB of shared memory
    with pytest.raises(ValueError):
        row_passes.launch_geometry(ct.cached_plan(200, ct.FFT_COMPLEX), 1)  # 200 % 16
