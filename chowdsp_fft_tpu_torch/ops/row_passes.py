"""Launch geometry of the row engine (``csrc/row_passes.cuh``) of K1-K4.

K1 (an M = N/2-point complex FFT per real row, then the split), K2/K3
(the merge, then an M-point backward FFT per real row) and K4 (an
N-point complex FFT per row) run the plan's mixed-radix stages fused in
consecutive pairs, a pass each, on rows of L points held in registers,
``POINTS_PER_THREAD`` points a thread, with two padded shared buffers per
row between passes. This module computes what a launch needs: the pass
plan, the threads, rows per block, shared bytes and grid. The C entries
check it again and refuse one that does not cover the rows or fit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..plans import FFT_COMPLEX, FFT_REAL, FFTPlan, cached_plan
from .tables import unordered_perm

__all__ = ["POINTS_PER_THREAD", "MIN_BLOCK_THREADS", "SMEM_LIMIT", "Geometry", "pass_plan", "row_points",
           "pass_twiddles", "device_tables", "launch_geometry"]

# Points a thread owns (csrc/row_passes.cuh kRowPoints, which the library
# reports as hopper_row_points_per_thread).
POINTS_PER_THREAD = 16
# A block holds whole rows and at least this many threads: rows of fewer
# than 128 * 16 points share a block.
MIN_BLOCK_THREADS = 128
# Shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448


def pass_plan(radices: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """The plan's stages fused in consecutive pairs, in their order, a lone
    last stage as ``(r, 1)``: (4,4,4,4,4,2) -> ((4,4), (4,4), (4,2))."""
    it = list(radices)
    return tuple((it[i], it[i + 1] if i + 1 < len(it) else 1) for i in range(0, len(it), 2))


def row_points(plan: FFTPlan) -> int:
    """L, the complex points of the row engine's transform: N for a complex
    plan, N/2 for a real one."""
    return plan.n if plan.kind == FFT_COMPLEX else plan.n // 2


def _padded(points: int) -> int:
    return points + (points >> 5)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A K1-K4 launch: ``passes`` ((r0, r1) pairs), ``threads_per_row``
    (L / POINTS_PER_THREAD), ``rows_per_block`` rows in a block, each with
    its own two padded buffers, ``threads`` and ``smem_bytes`` per block,
    ``grid`` blocks (the last one ragged)."""

    passes: tuple[tuple[int, int], ...]
    threads_per_row: int
    rows_per_block: int
    threads: int
    smem_bytes: int
    grid: int

    @property
    def flat_passes(self) -> tuple[int, ...]:
        """The pass plan as the C entries take it: r0, r1, r0, r1, ..."""
        return tuple(r for pair in self.passes for r in pair)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """The grid entries' trailing geometry arguments."""
        return self.rows_per_block, self.threads, self.smem_bytes, self.grid


def launch_geometry(plan: FFTPlan, rows: int) -> Geometry:
    """The launch of K1-K3 (real plan) or K4 (complex plan) on ``rows`` rows:
    the pass plan of the plan's radices, L / POINTS_PER_THREAD threads a
    row, and as many rows a block as it takes to reach MIN_BLOCK_THREADS."""
    passes, tpr, rpb, smem = _block(plan.n, plan.kind, plan.radices)
    return Geometry(passes, tpr, rpb, rpb * tpr, smem, -(-rows // rpb))


@functools.lru_cache(maxsize=256)
def _block(n: int, kind: str, radices: tuple[int, ...]) -> tuple[tuple[tuple[int, int], ...], int, int, int]:
    """What a launch takes from the size alone (cached: a wrapper asks at
    every call): the pass plan, threads per row, rows per block and
    shared bytes."""
    L = n if kind == FFT_COMPLEX else n // 2
    if L % POINTS_PER_THREAD:
        raise ValueError(f"row engine: {L} points are not a multiple of {POINTS_PER_THREAD}")
    tpr = L // POINTS_PER_THREAD
    rpb = max(1, -(-MIN_BLOCK_THREADS // tpr))
    smem = rpb * 2 * _padded(L) * 8
    if smem > SMEM_LIMIT or rpb * tpr > 1024:
        raise ValueError(f"row engine: {L} points do not fit a block")
    return pass_plan(radices), tpr, rpb, smem


def pass_twiddles(radices: tuple[int, ...], L: int, passes: tuple[tuple[int, int], ...] | None = None) -> np.ndarray:
    """The passes' twiddle tables, concatenated in pass order (complex64),
    for ``passes`` (default: this module's :func:`pass_plan` of the radices):
    pass i (radix P = R0*R1, stride s, m = L/(P*s)) holds W_L^(j*p*s) at
    [j*m + p] for bin j < P and p < m, so that a warp's threads (p = u/s,
    consecutive or equal) read consecutive or equal entries. Each entry
    is exp(-2i*pi*e/L) for the exact integer e = j*p*s mod L, in float64,
    cast to float32 once."""
    out, s = [], 1
    for r0, r1 in pass_plan(radices) if passes is None else passes:
        P = r0 * r1
        m = L // (P * s)
        e = (np.arange(P, dtype=np.int64)[:, None] * np.arange(m, dtype=np.int64)[None, :] * s) % L
        out.append(np.exp(-2j * np.pi * e.astype(np.float64) / L).reshape(-1))
        s *= P
    return np.concatenate(out).astype(np.complex64)


@functools.lru_cache(maxsize=128)
def device_tables(n: int, kind: str, device: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The tables a K1-K4 launch reads beyond the plan's own, on
    ``device``: the pass twiddles of the plan's L-point transform and, for
    a real plan, its split twiddles gathered into the unordered layout
    (position p: W_N^perm[p]), which the unordered epilogue reads in
    position order."""
    plan = cached_plan(n, kind)
    tw = torch.from_numpy(pass_twiddles(plan.radices, row_points(plan))).to(device)
    split = None
    if kind == FFT_REAL:
        perm = unordered_perm(n)
        split = torch.complex(torch.from_numpy(plan.rfft_tw_re[perm]), torch.from_numpy(plan.rfft_tw_im[perm]))
        split = split.to(device)
    return tw, split
