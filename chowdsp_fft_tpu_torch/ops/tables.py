"""Host-side tables shared by the Hopper kernels and their plain versions.

numpy only. The Stockham kernels (K1-K4) read the plan's own twiddles
(``plans.make_plan``: per-stage W_n^(j*p) and the real split W_N^k, both
computed in float64 and stored in float32) and the unordered permutations
below; the small-N direct DFT (K5) reads :func:`small_roots`.
"""

from __future__ import annotations

import functools

import numpy as np

from ..plans import InvalidSizeError, factorize

# Width of the unordered layout's inner digit: the JAX package's four-step
# kernel factors N = N1 * 128 and keeps the 64 non-redundant bins of the
# 128-point merge per k1 row.
LANES = 128


def is_smooth_multiple(n: int) -> bool:
    """N = n1 * 128 with n1 {2,3,5}-smooth: the sizes of the Stockham
    kernels' unordered layouts, in both packages."""
    if n % LANES:
        return False
    try:
        factorize(n // LANES)
    except InvalidSizeError:
        return False
    return True


@functools.lru_cache(maxsize=64)
def unordered_perm(n: int) -> np.ndarray:
    """The unordered packed layout of an N-point real transform, N = N1*128.

    Position ``k1*64 + k2`` (k1 in [0, N1), k2 in [0, 64)) holds bin
    ``k1 + N1*k2``; bin 0 sits at position 0 and the Nyquist bin stays in
    im[0]. Returns ``perm`` (int32, length N/2, read-only) with
    ``unordered[..., p] == ordered[..., perm[p]]``. It depends on N alone,
    never on the batch, and is the JAX package's layout, so unordered
    spectra and filter state cross between the packages unchanged.
    """
    if n % LANES:
        raise ValueError(f"unordered layout needs N % {LANES} == 0, got N={n}")
    n1 = n // LANES
    half = LANES // 2
    p = np.arange(n // 2, dtype=np.int64)
    perm = (p // half + n1 * (p % half)).astype(np.int32)
    perm.setflags(write=False)
    return perm


@functools.lru_cache(maxsize=64)
def inverse_perm(n: int) -> np.ndarray:
    """``inv`` with ``ordered[..., k] == unordered[..., inv[k]]``."""
    return _inverse(unordered_perm(n))


@functools.lru_cache(maxsize=64)
def cfft_unordered_perm(n: int) -> np.ndarray:
    """The unordered layout of an N-point complex transform, N = N1*128.

    Position ``k1*128 + k2`` (k1 in [0, N1), k2 in [0, 128)) holds bin
    ``k1 + N1*k2``: the inverse of the JAX package's ``_digit_transpose``.
    Not the real layout of :func:`unordered_perm` (``k1*64 + k2``): a
    complex row keeps all 128 bins of each merge column. Returns ``perm``
    (int32, length N, read-only) with
    ``unordered[..., p] == ordered[..., perm[p]]``.
    """
    if n % LANES:
        raise ValueError(f"unordered layout needs N % {LANES} == 0, got N={n}")
    n1 = n // LANES
    p = np.arange(n, dtype=np.int64)
    perm = (p // LANES + n1 * (p % LANES)).astype(np.int32)
    perm.setflags(write=False)
    return perm


@functools.lru_cache(maxsize=64)
def cfft_inverse_perm(n: int) -> np.ndarray:
    """``inv`` with ``ordered[..., k] == unordered[..., inv[k]]`` for the
    complex layout."""
    return _inverse(cfft_unordered_perm(n))


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.argsort(perm).astype(np.int32)
    inv.setflags(write=False)
    return inv


# ---------------------------------------------------------------------------
# Small-N direct DFT (K5). The kernels read only the N roots W^m and index
# them by (j*k) mod N; the matrices below are the same float32 values laid
# out as the JAX package's _small_tables_c/r/ri (without its 128-lane
# block-diagonal packing), for the plain versions. All built in float64
# from the reduced index and cast once.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def small_roots(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) float32 of W^m = exp(-2i*pi*m/N), m in [0, N)."""
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / float(n)
    return _frozen(np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _frozen(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """The arrays, read-only (cached results are shared by every caller)."""
    for a in arrays:
        a.setflags(write=False)
    return arrays


def _root_matrix(n: int, rows: np.ndarray, cols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(W^((r*c) mod N).re, .im) over the outer product of ``rows``, ``cols``."""
    re, im = small_roots(n)
    idx = np.outer(rows, cols) % n
    return re[idx], im[idx]


@functools.lru_cache(maxsize=64)
def small_tables_c(n: int, forward: bool) -> tuple[np.ndarray, np.ndarray]:
    """(N, N) complex DFT matrix planes: y = x @ (Wr + i Wi); the backward
    matrix is the conjugate."""
    j = np.arange(n)
    wr, wi = _root_matrix(n, j, j)
    return _frozen(wr, wi if forward else -wi)


@functools.lru_cache(maxsize=64)
def small_tables_r(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-forward matrices (N, N/2): x @ Cr = re plane, x @ Ci = im
    plane; Ci's column 0 is (-1)^n, so the Nyquist bin lands in im[0]."""
    cr, ci = _root_matrix(n, np.arange(n), np.arange(n // 2))
    ci[:, 0] = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return _frozen(cr, ci)


@functools.lru_cache(maxsize=64)
def small_tables_ri(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-inverse matrices (N/2, N), unscaled: x = re @ Dr + im @ Di with
    x_n = X0 + (-1)^n X_{N/2} + sum_{k>=1} 2(re_k cos - im_k sin)."""
    wr, wi = _root_matrix(n, np.arange(n // 2), np.arange(n))
    dr = 2.0 * wr  # 2 cos(2*pi*k*n/N); scaling by 2 is exact
    di = 2.0 * wi  # -2 sin(2*pi*k*n/N), since W = exp(-2i*pi/N)
    dr[0, :] = 1.0
    di[0, :] = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return _frozen(dr, di)
