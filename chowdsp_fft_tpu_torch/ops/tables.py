"""Host-side tables shared by the Hopper kernels and their plain versions.

numpy only (plus the column kernel's length limit, ``_cuda.MAX_COL``).
The Stockham kernels (K1-K4) read the plan's own twiddles
(``plans.make_plan``: per-stage W_n^(j*p) and the real split W_N^k, both
computed in float64 and stored in float32) and the unordered permutations
below; the small-N FFT (K5) reads the same plan twiddles, and its plain
versions the direct-DFT matrices built from :func:`small_roots`; the
two-level composite (K6, K7) reads :func:`split_large` and the four-step
twiddles at the end of this module.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..plans import InvalidSizeError, factorize
from ._cuda import MAX_COL

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
# Small-N direct DFT: the plain versions of K5 (whose kernels run the
# plan's FFT stages instead). The matrices hold the N roots W^m, indexed by
# (j*k) mod N and laid out as the JAX package's _small_tables_c/r/ri
# (without its 128-lane block-diagonal packing). All built in float64 from
# the reduced index and cast once.
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


# ---------------------------------------------------------------------------
# Two-level composite (K6, K7): the JAX package's split rule and four-step
# tables (pallas_fft.py :2392-2467, :3064-3108). The predicates below keep
# the JAX engine's own size constants, which say where ITS kernels end; the
# port's kernel limits are ``_cuda.MAX_N``/``MAX_CN``/``MAX_COL``.
# ---------------------------------------------------------------------------

JAX_MIN_SMALL = 8  # smallest N of the JAX direct DFT (_MIN_SMALL)
JAX_MAX_SMALL = 256  # direct DFT for every N up to here (_MAX_SMALL)
JAX_MAX_SMALL_FALLBACK = 511  # and smooth non-multiples of 128 below 512
JAX_MIN_N = 2 * LANES  # smallest JAX Stockham kernel size (_MIN_N)
JAX_MAX_N = 1 << 17  # largest JAX single-kernel size (_MAX_N)
JAX_MAX_COMPOSITE = 1 << 20  # largest JAX two-level size (_MAX_COMPOSITE)


def jax_small_dispatch(n: int) -> bool:
    """The JAX engine's direct-DFT sizes (``_small_dispatch``)."""
    if n <= JAX_MAX_SMALL:
        return n >= JAX_MIN_SMALL
    return n <= JAX_MAX_SMALL_FALLBACK and not is_smooth_multiple(n)


def jax_kernel_size_ok(x: int) -> bool:
    """x runs in one JAX Stockham kernel (``_kernel_size_ok``)."""
    return JAX_MIN_N <= x <= JAX_MAX_N and is_smooth_multiple(x)


def jax_level_ok(x: int) -> bool:
    """x can be one JAX composite level (``_level_ok``)."""
    return jax_kernel_size_ok(x) or jax_small_dispatch(x)


@functools.lru_cache(maxsize=256)
def jax_split_large(n: int, real: bool = False) -> tuple[int, int]:
    """The JAX package's ``_split_large``: n = A * C, A >= C, both factors
    JAX composite levels, the most balanced kernel-kernel pair if there is
    one, else the most balanced pair of level sizes (both even with
    ``real``). Raises InvalidSizeError where there is none."""
    best = None
    for a in range(JAX_MIN_N, JAX_MAX_N + 1, LANES):
        if n % a:
            continue
        c = n // a
        if c > a:
            continue
        if jax_kernel_size_ok(a) and jax_kernel_size_ok(c):
            if best is None or a / c < best[0] / best[1]:
                best = (a, c)
    if best is not None:
        return best
    hi = min(n // JAX_MIN_SMALL, JAX_MAX_N)
    for a in range(math.isqrt(n - 1) + 1, hi + 1):
        if n % a:
            continue
        c = n // a
        if real and (a % 2 or c % 2):
            continue
        if jax_level_ok(a) and jax_level_ok(c):
            return a, c
    raise InvalidSizeError(f"N={n} has no two-level composite split in the JAX package")


def jax_has_composite_split(n: int, real: bool = False) -> bool:
    """Whether the JAX engine serves N as its two-level composite
    (``_has_composite_split``)."""
    if n > JAX_MAX_COMPOSITE:
        return False
    try:
        jax_split_large(n, real)
    except InvalidSizeError:
        return False
    return True


def jax_cfft_composite_is_natural(n: int) -> bool:
    """Whether the JAX complex composite at N is its two-kernel v2 form,
    whose unordered layout is natural order at every batch: both split
    factors are multiples of 128 (``_v2_batch_cap`` > 0 at N <= 2^20).
    Otherwise it runs its v1 chain, whose unordered layout is the factor
    split's digit transpose."""
    try:
        a, c = jax_split_large(n)
    except InvalidSizeError:
        return False
    return a % LANES == 0 and c % LANES == 0


@functools.lru_cache(maxsize=256)
def split_large(n: int, real: bool = False) -> tuple[int, int]:
    """The port's composite split n = A * C, A >= C: the JAX package's
    where the column kernel holds both factors (8 <= factor <= MAX_COL),
    else the most balanced pair it holds (both even with ``real``: the
    real level 1 packs A in half and the Hermitian assembly halves C).
    Natural-order output does not depend on the split."""
    try:
        a, c = jax_split_large(n, real)
        if c >= JAX_MIN_SMALL and a <= MAX_COL:
            return a, c
    except InvalidSizeError:
        pass
    for a in range(math.isqrt(n - 1) + 1, min(n // JAX_MIN_SMALL, MAX_COL) + 1):
        if n % a:
            continue
        c = n // a
        if real and (a % 2 or c % 2):
            continue
        return a, c
    raise InvalidSizeError(f"N={n} has no composite split with both factors in [8, {MAX_COL}]")


def _cos_sin(ang: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return _frozen(np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=32)
def large_twiddle(n: int, forward: bool) -> tuple[np.ndarray, np.ndarray]:
    """(C, A) four-step twiddle W_N^(sgn * c * k1), natural k1 order
    (``_large_twiddle(folded=False)``), float64 -> float32."""
    a, c = split_large(n)
    sgn = -1.0 if forward else 1.0
    k1 = np.arange(a, dtype=np.float64)[None, :]
    cc = np.arange(c, dtype=np.float64)[:, None]
    return _cos_sin(sgn * 2.0 * np.pi * (cc * k1) / float(n))


@functools.lru_cache(maxsize=32)
def rdc_l2_twiddle(n: int, forward: bool) -> tuple[np.ndarray, np.ndarray]:
    """(C, A/2) level-2 twiddle of the real composite, W_N^(sgn * k1 * c)
    for k1 in [0, A/2) (``_rdc_l2_twiddle``); column 0 is (1, 0)."""
    a, c = split_large(n, real=True)
    sgn = -1.0 if forward else 1.0
    cc = np.arange(c, dtype=np.float64)[:, None]
    k1 = np.arange(a // 2, dtype=np.float64)[None, :]
    return _cos_sin(sgn * 2.0 * np.pi * (cc * k1) / float(n))


@functools.lru_cache(maxsize=32)
def nyquist_twiddle(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(C,) half-bin modulation W_{2C}^(-c) of the real composite's
    level-1 Nyquist line (``_direct_real_tables``' ``nyt``): it turns that
    line's half-bin-shifted transform into a plain length-C FFT."""
    _, c = split_large(n, real=True)
    return _cos_sin(-np.pi * np.arange(c, dtype=np.float64) / float(c))
