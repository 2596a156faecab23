"""Host-side index tables shared by the Hopper kernels and their twins.

numpy only. The twiddle tables the kernels read are the plan's own
(``plans.make_plan``: per-stage W_n^(j*p) and the real split W_N^k, both
computed in float64 and stored in float32).
"""

from __future__ import annotations

import functools

import numpy as np

# Width of the unordered layout's inner digit: the JAX package's four-step
# kernel factors N = N1 * 128 and keeps the 64 non-redundant bins of the
# 128-point merge per k1 row.
LANES = 128


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
    inv = np.argsort(unordered_perm(n)).astype(np.int32)
    inv.setflags(write=False)
    return inv
