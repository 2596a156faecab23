"""Port parity: the pipelined forms K1-db, K2-db and K4-db (through their
plain versions on the CPU) against the JAX package's
``_rfft_packed_joint_db``, ``_irfft_packed_db`` and ``_cfft_pair_db`` in
interpret mode, on the same numpy inputs, as test_pallas_engine.py
drives them: a ragged three-chunk batch of JAX's own tile and a single
chunk.

Tolerance: 2e-7*N max abs error, the JAX package's bound, for port vs JAX
and for either vs float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu.ops import pallas_fft
from chowdsp_fft_tpu_torch.ops import hopper_cfft, tables
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf


def tol(n):
    return 2.0e-7 * n


def close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def real_rows(n: int, chunks: int) -> int:
    """JAX's test batches: three chunks of its real tile with a ragged
    tail, or one chunk."""
    return 3 * pallas_fft._rbatch_tile(n, 10**9) - 8 if chunks == 3 else 16


def packed64(x: np.ndarray, n: int, ordered: bool) -> np.ndarray:
    """float64 joint rows [re | im], Nyquist in im[0]."""
    sp = np.fft.rfft(x.astype(np.float64), axis=-1)
    m = n // 2
    re, im = sp.real[:, :m].copy(), sp.imag[:, :m].copy()
    im[:, 0] = sp.real[:, m]
    if not ordered:
        perm = tables.unordered_perm(n)
        re, im = re[:, perm], im[:, perm]
    return np.concatenate([re, im], 1)


@pytest.mark.parametrize("chunks", [3, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_k1_db_matches_jax(ordered, chunks):
    n = 512
    x = np.random.default_rng(n + chunks).standard_normal((real_rows(n, chunks), n)).astype(np.float32)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    want = np.asarray(pallas_fft._rfft_packed_joint_db(jnp.asarray(x), n, ordered))
    got = hf.rfft_packed_joint_db_kernel(torch.from_numpy(x), plan, ordered)
    assert got.shape == (x.shape[0], n) and got.dtype == torch.float32
    close(got, want, tol(n))
    close(got, packed64(x, n, ordered), tol(n))
    # the grid form's joint output, against JAX's _rfft_packed_joint
    grid = hf.rfft_packed_joint_kernel(torch.from_numpy(x), plan, ordered)
    close(grid, np.asarray(pallas_fft._rfft_packed_joint(jnp.asarray(x), n, ordered)), tol(n))
    assert torch.equal(grid, got)


@pytest.mark.parametrize("chunks", [3, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_k2_db_matches_jax(ordered, chunks):
    n, m = 512, 256
    rng = np.random.default_rng(2 * n + chunks)
    b = real_rows(n, chunks)
    yre = rng.standard_normal((b, m)).astype(np.float32)
    yim = rng.standard_normal((b, m)).astype(np.float32)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    want = np.asarray(pallas_fft._irfft_packed_db(jnp.asarray(yre), jnp.asarray(yim), n, ordered))
    got = hf.irfft_packed_db_kernel(torch.from_numpy(yre), torch.from_numpy(yim), plan, ordered)
    assert got.shape == (b, n)
    close(got, want, tol(n))


@pytest.mark.parametrize("chunks", [3, 1])
@pytest.mark.parametrize("reverse_order", [False, True])
def test_k4_db_matches_jax(reverse_order, chunks):
    """JAX's two pipeline orders: natural in, unordered out (forward), and
    unordered in, natural out (backward), on SoA planes."""
    n = 512
    b = 3 * pallas_fft._batch_tile(n, 10**9) - 8 if chunks == 3 else 16
    rng = np.random.default_rng(3 * n + chunks)
    xre = rng.standard_normal((b, n)).astype(np.float32)
    xim = rng.standard_normal((b, n)).astype(np.float32)
    forward = not reverse_order
    want = pallas_fft._cfft_pair_db(jnp.asarray(xre), jnp.asarray(xim), n, forward, reverse_order)
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    yre, yim = hopper_cfft.cfft_db_kernel((torch.from_numpy(xre), torch.from_numpy(xim)), plan, forward,
                                          ordered=False)
    close(yre, want[0], tol(n))
    close(yim, want[1], tol(n))
    # and the complex64 form gives the same
    z = torch.complex(torch.from_numpy(xre), torch.from_numpy(xim))
    y = hopper_cfft.cfft_db_kernel(z, plan, forward, ordered=False)
    assert torch.equal(y, torch.complex(yre, yim))


@pytest.mark.parametrize("n", [512, 1920, 4096])
@pytest.mark.parametrize("ordered", [True, False])
def test_db_round_trip(n, ordered):
    """irfft_db(rfft_db(x)) / N == x, and the complex pair likewise."""
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    j = hf.rfft_packed_joint_db_kernel(torch.from_numpy(x), plan, ordered)
    m = n // 2
    back = hf.irfft_packed_db_kernel(j[:, :m].contiguous(), j[:, m:].contiguous(), plan, ordered) / n
    close(back, x, tol(n))
    cplan = ct.cached_plan(n, ct.FFT_COMPLEX)
    z = torch.from_numpy(x) + 1j * torch.from_numpy(x[::-1].copy())
    zb = hopper_cfft.cfft_db_kernel(hopper_cfft.cfft_db_kernel(z, cplan, True, ordered), cplan, False, ordered) / n
    close(torch.view_as_real(zb), torch.view_as_real(z).numpy(), tol(n))


@pytest.mark.parametrize("kind,n", [("real", 256), ("real", 32768), ("complex", 256), ("complex", 16384)])
def test_db_wrappers_refuse_other_families(kind, n):
    """Each pipelined form serves exactly its grid kernel's domain: a K5
    size and a composite size are refused (JAX: ``assert not
    _small_dispatch(n)``), on the CPU as on the card."""
    plan = ct.cached_plan(n, kind)
    assert hf.supports_plan(plan)
    m = n // 2
    if kind == "real":
        calls = [(hf.rfft_packed_joint_db_kernel, (torch.zeros(2, n), plan)),
                 (hf.irfft_packed_db_kernel, (torch.zeros(2, m), torch.zeros(2, m), plan)),
                 (hopper_cfft.cfft_db_kernel, (torch.zeros(2, n, dtype=torch.complex64), plan))]
    else:
        calls = [(hopper_cfft.cfft_db_kernel, (torch.zeros(2, n, dtype=torch.complex64), plan)),
                 (hf.rfft_packed_joint_db_kernel, (torch.zeros(2, n), plan))]
    for fn, args in calls:
        with pytest.raises(ValueError, match="outside the kernel domain"):
            fn(*args)


def test_db_kernels_are_listed_with_their_sources():
    """The three records are in KERNELS and name their JAX functions and
    the source that replaces them."""
    db = (hf.K1_DB, hf.K2_DB, hopper_cfft.K4_DB)
    assert all(k in hf.KERNELS for k in db) and len(hf.KERNELS) == 16
    for k, fn in zip(db, ("_rfft_packed_joint_db", "_irfft_packed_db", "_cfft_pair_db")):
        assert fn in k.replaces and k.source.endswith("csrc/pipelined_fft.cu")
