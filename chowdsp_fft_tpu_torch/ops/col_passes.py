"""Launch geometry of the composite's column engine (``csrc/col_passes.cuh``).

K6 (the column FFT of the two-level complex composite, in its four roles),
K7a and K7b (the real composite's column-blocked level 1 and its inverse)
run the plan's mixed-radix stages on a tile of ``2^ls`` adjacent columns
of L points, ``POINTS_PER_THREAD`` points of one column a thread. A pass
fuses one or two consecutive stages of the plan; the kernels load each
thread's points from device memory straight into registers and store them
from registers (K7a from the tile, after its split).
The passes between exchange through two padded tile buffers (narrow tiles,
three blocks an SM, or wide ones, one block an SM), or in place through
one where the plan's middle passes are all (4,4) (two blocks an SM).

This module computes what a launch needs: the pass plan, the tile
(columns, threads, buffers), the shared bytes and the grid. The C entries
check it again and refuse one that does not cover the columns or fit.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..plans import FFTPlan
from .row_passes import POINTS_PER_THREAD, SMEM_LIMIT, pass_twiddles

__all__ = ["POINTS_PER_THREAD", "TILE_POINTS", "WIDE_TILE_POINTS", "SECTOR_BYTES", "IN_PLACE_TILE_POINTS", "NARROW_THREADS", "MAX_LANES", "MAX_THREADS", "BUFFERS", "MAX_RADIX", "PASS_KINDS", "ColGeometry",
           "pass_plan", "in_place_plan", "launch_geometry", "device_twiddles"]

# A narrow tile holds at most this many complex points: its two padded
# buffers take 67.6 KB and its 256 threads 80 registers each, so three
# blocks share an SM.
TILE_POINTS = 4096
# A wide tile (two buffers of 135 KB, 512 threads, one block an SM) where a
# narrow one would leave a column less than a 32-byte sector a row and
# plane: planes at L = 1024, complex64 at L = 2048.
WIDE_TILE_POINTS = 8192
SECTOR_BYTES = 32
# Plans whose passes between the first and the last are all (4,4) and whose
# last pass has P | 16 may run in place in one tile buffer (in_place_plan):
# up to this many points, 512 threads and 64 registers a thread, two blocks
# an SM.
IN_PLACE_TILE_POINTS = 8192
# At most 16 columns a tile: 128 B a row of interleaved complex64 on the
# column side, 64 B a row of each plane.
MAX_LANES = 16
# Threads a block at most: the wide tiles' launch bound (csrc/col_passes.cuh
# kColMaxThreads; narrow tiles take at most 256, kColNarrowThreads).
MAX_THREADS = 512
NARROW_THREADS = 256
# Tile buffers a block holds in shared memory (the passes go from one to
# the other).
BUFFERS = 2
# The largest fused radix: a butterfly's points live in registers one
# butterfly at a time, so a pass of radix P holds P points.
MAX_RADIX = 20
# Pass kinds the kernels have (csrc/col_passes.cuh dispatch_shared): every
# pair of consecutive stages of the plans' radix order (4s, a 2, 3s, 5s)
# up to MAX_RADIX points, and single stages; (5, 5) stays two passes.
PASS_KINDS = ((4, 4), (4, 2), (4, 3), (4, 5), (2, 3), (2, 5), (3, 3), (3, 5), (4, 1), (2, 1), (3, 1), (5, 1))


def pass_plan(radices: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """The plan's stages in order, consecutive pairs fused where the pair
    is one of ``PASS_KINDS`` (at most MAX_RADIX points a butterfly), else
    one stage a pass: (4,4,4,4,4) -> ((4,4), (4,4), (4,1));
    (4,2,5,5,5) -> ((4,2), (5,1), (5,1), (5,1))."""
    out, i = [], 0
    while i < len(radices):
        if i + 1 < len(radices) and (radices[i], radices[i + 1]) in PASS_KINDS:
            out.append((radices[i], radices[i + 1]))
            i += 2
        else:
            out.append((radices[i], 1))
            i += 1
    return tuple(out)


def _padded(points: int) -> int:
    return points + (points >> 5)


def in_place_plan(length: int, passes: tuple[tuple[int, int], ...]) -> bool:
    """Whether the plan runs in place: 16 | L (so the first pass is (4,4)),
    at least two passes, (4,4) between the first and the last, and a last
    pass of P | 16."""
    return (length % POINTS_PER_THREAD == 0 and len(passes) >= 2 and all(p == (4, 4) for p in passes[1:-1])
            and passes[-1] in ((4, 4), (4, 2), (4, 1), (2, 1)))


@dataclasses.dataclass(frozen=True)
class ColGeometry:
    """A K6/K7a/K7b launch: ``passes`` ((r0, r1) pairs), a tile of
    ``2^lanes_shift`` adjacent columns, ``threads_per_col`` = ceil(L / 16)
    threads a column, ``threads`` and ``smem_bytes`` (one padded tile
    buffer) a block, ``grid`` blocks (batch rows x tiles; the last tile of
    a row is ragged where the columns do not divide)."""

    passes: tuple[tuple[int, int], ...]
    lanes_shift: int
    threads_per_col: int
    threads: int
    smem_bytes: int
    grid: int
    buffers: int = BUFFERS

    @property
    def lanes(self) -> int:
        return 1 << self.lanes_shift

    @property
    def shape(self) -> int:
        """The kernel shape the C entries pick: 0 narrow, 1 wide, 2 in place."""
        return 2 if self.buffers == 1 else 0 if self.threads <= NARROW_THREADS else 1

    @property
    def flat_passes(self) -> tuple[int, ...]:
        """The pass plan as the C entries take it: r0, r1, r0, r1, ..."""
        return tuple(r for pair in self.passes for r in pair)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """The C entries' trailing geometry arguments."""
        return self.lanes_shift, self.threads, self.smem_bytes, self.grid


def launch_geometry(plan: FFTPlan, batch: int, cols: int, segment_bytes: int, in_place: bool) -> ColGeometry:
    """The launch of the column engine over ``batch`` rows of ``cols``
    columns of L points, L the plan's complex length (N for a complex
    plan: K6; N/2 for a real one: K7a, K7b), a column taking
    ``segment_bytes`` a row and plane on its column side (8 complex64, 4
    planes or K7's real samples): with ``in_place`` and a plan that allows it, the widest
    in-place tile up to MAX_LANES columns and IN_PLACE_TILE_POINTS; else
    the widest narrow tile, widened up to WIDE_TILE_POINTS where its
    columns would move less than SECTOR_BYTES a row and plane."""
    length = plan.n if plan.kind == "complex" else plan.n // 2
    passes, ls, tpc, smem, buffers = _tile(length, plan.radices, segment_bytes, in_place)
    return ColGeometry(passes, ls, tpc, tpc << ls, smem, batch * -(-cols // (1 << ls)), buffers)


@functools.lru_cache(maxsize=256)
def _tile(length: int, radices: tuple[int, ...], segment_bytes: int, in_place: bool):
    """What a launch takes from the length alone (cached: a wrapper asks at
    every call): the pass plan, the lanes' shift, threads a column, shared
    bytes and tile buffers."""
    if length < 2 or length > WIDE_TILE_POINTS:
        raise ValueError(f"column engine: columns of {length} points are outside [2, {WIDE_TILE_POINTS}]")
    passes = pass_plan(radices)
    ls, buffers = 0, BUFFERS
    if in_place and in_place_plan(length, passes):
        buffers = 1
        while (2 << ls) <= MAX_LANES and (length << (ls + 1)) <= IN_PLACE_TILE_POINTS:
            ls += 1
    else:
        while (2 << ls) <= MAX_LANES and (length << (ls + 1)) <= TILE_POINTS:
            ls += 1
        while ((1 << ls) * segment_bytes < SECTOR_BYTES and (2 << ls) <= MAX_LANES
               and (length << (ls + 1)) <= WIDE_TILE_POINTS):
            ls += 1
    tpc = -(-length // POINTS_PER_THREAD)
    smem = buffers * _padded(length << ls) * 8
    if smem > SMEM_LIMIT or (tpc << ls) > MAX_THREADS:
        raise ValueError(f"column engine: columns of {length} points do not fit a block")
    return passes, ls, tpc, smem, buffers


@functools.lru_cache(maxsize=128)
def device_twiddles(n: int, kind: str, radices: tuple[int, ...], device: str) -> torch.Tensor:
    """The column passes' twiddle tables of a plan (complex64 on
    ``device``): ``row_passes.pass_twiddles`` laid out for this module's
    pass plan."""
    length = n if kind == "complex" else n // 2
    return torch.from_numpy(pass_twiddles(radices, length, pass_plan(radices))).to(device)
