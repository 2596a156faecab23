"""K5 as a row-tiled mixed-radix FFT, on the CPU: its launch geometry at
every size of its domain, the plan tables its kernels read (run in plain
torch by the Stockham engine, the kernels' algorithm) against float64
numpy, and those tables against the JAX package's K5 (its Pallas engine
in interpret mode) on sizes that cover each radix pattern.

Tolerance: 2e-7*N max abs error (the JAX package's bound), outputs of
backward transforms divided by N.
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import hopper_small as hs
from chowdsp_fft_tpu_torch.plans import is_valid_size

SIZES = [n for n in range(hs.MIN_SMALL, hs.MAX_SMALL_N + 1) if hs.in_domain(n) and is_valid_size(n)]
# One size per radix pattern: 4/2 only, 3 only, 5 only, mixed, the largest.
JAX_SIZES = [8, 9, 25, 96, 125, 240, 243, 256, 405, 480]
# Dynamic shared memory one block may opt in to on sm_90; the K5 kernels
# declare no static shared memory, so all of it is theirs.
SM90_SMEM_BYTES = 232448


def tol(n):
    return 2.0e-7 * n


def close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def sizes_of(kind):
    return [n for n in SIZES if kind == "complex" or n % 2 == 0]


def test_domain_is_every_smooth_size_below_512_but_the_k4_sizes():
    assert SIZES[0] == 8 and SIZES[-1] == 500 and len(SIZES) == 60
    assert 384 not in SIZES and 256 in SIZES and 480 in SIZES


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_launch_geometry_at_every_size(kind):
    for n in sizes_of(kind):
        m = n if kind == "complex" else n // 2
        tile = hs.launch_geometry(n, kind, 1).tile_rows
        for rows in (0, 1, tile - 1, tile + 1, 32768):
            g = hs.launch_geometry(n, kind, rows)
            t = g.tile_rows
            assert t == 1 << g.shift and t & (t - 1) == 0
            pts = m * t
            assert pts <= hs.TILE_POINTS < 2 * pts, (n, kind)  # the largest such tile
            assert g.threads % 32 == 0 and 64 <= g.threads <= 1024
            assert hs.POINTS_PER_THREAD * g.threads >= pts  # the kernels' per-thread walk
            assert g.smem_bytes == 2 * 8 * (pts + pts // 32)
            assert g.smem_bytes <= SM90_SMEM_BYTES
            assert g.grid * t >= rows and (g.grid - 1) * t < max(rows, 1)
            assert g.args == (g.shift, g.threads, g.smem_bytes, g.grid)


def test_launch_geometry_on_the_paths():
    """Config 5's ifft and the block-128 FIR (N = 256): 512-point tiles
    of 64 threads."""
    c = hs.launch_geometry(256, "complex", 32768)
    assert (c.tile_rows, c.threads, c.smem_bytes, c.grid) == (2, 64, 8448, 16384)
    r = hs.launch_geometry(256, "real", 32768)
    assert (r.tile_rows, r.threads, r.smem_bytes, r.grid) == (4, 64, 8448, 8192)


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_plan_tables_match_float64_at_every_size(kind):
    """The stage (and split) tables the K5 kernels read, run by the
    Stockham engine in plain torch, at every size of the domain; a batch
    of 5 rows with a ragged count."""
    for n in sizes_of(kind):
        rng = np.random.default_rng(n)
        if kind == "complex":
            z = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
            y = ct.fft(torch.from_numpy(z), engine="stockham")
            ref = np.fft.fft(z.astype(np.complex128), axis=-1)
            close(y, ref, tol(n))
            back = ct.ifft(torch.from_numpy(ref.astype(np.complex64)), engine="stockham")
            close(back / n, z, tol(n))
        else:
            x = rng.standard_normal((5, n)).astype(np.float32)
            re, im = ct.rfft_packed(torch.from_numpy(x), engine="stockham")
            sp = np.fft.rfft(x.astype(np.float64), axis=-1)
            close(re, sp.real[:, : n // 2], tol(n))
            close(im[:, 1:], sp.imag[:, 1 : n // 2], tol(n))
            close(im[:, 0], sp.real[:, n // 2], tol(n))  # Nyquist in im[0]
            back = ct.irfft_packed(re, im, engine="stockham")
            close(back / n, x, tol(n))


@pytest.mark.parametrize("n", JAX_SIZES)
def test_plan_tables_match_jax_k5(n):
    """The same tables against JAX's K5 (``_small_call`` in interpret
    mode); the Hopper engine's plain versions (the direct DFT) too."""
    rng = np.random.default_rng(1000 + n)
    z = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    zt = torch.from_numpy(z)
    want = np.asarray(cf.fft(z, engine="pallas"))
    close(ct.fft(zt, engine="stockham"), want, tol(n))
    close(ct.fft(zt, engine="hopper"), want, tol(n))
    close(ct.ifft(zt, engine="stockham") / n, np.asarray(cf.ifft(z, engine="pallas")) / n, tol(n))
    if n % 2:
        return
    x = np.ascontiguousarray(z.real)
    jre, jim = (np.array(a) for a in cf.rfft_packed(x, engine="pallas"))
    re, im = ct.rfft_packed(torch.from_numpy(x), engine="stockham")
    close(re, jre, tol(n))
    close(im, jim, tol(n))
    jback = np.asarray(cf.irfft_packed(jre, jim, engine="pallas"))
    close(ct.irfft_packed(torch.from_numpy(jre), torch.from_numpy(jim), engine="stockham") / n, jback / n, tol(n))
