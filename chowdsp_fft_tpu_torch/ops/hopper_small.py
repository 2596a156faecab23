"""K5: the small-N transforms on hand-written CUDA kernels
(``csrc/small_fft.cu``), counterpart of ``_small_call`` and its three
bodies in ``chowdsp_fft_tpu/ops/pallas_fft.py``.

- ``small_cfft_kernel``: complex rows (complex64, or a (re, im) pair of
  float32 planes) -> the same form, forward or backward, unscaled;
- ``small_rfft_kernel``: (rows, N) f32 -> packed planes (rows, N/2) x2,
  DC in re[0] and Nyquist in im[0];
- ``small_irfft_kernel``: packed planes -> (rows, N) f32, unscaled.

The kernels are row-tiled mixed-radix FFTs: a block runs the plan's
Stockham stages on a tile of ``2^shift`` consecutive rows
(:func:`launch_geometry`), the real bodies on the N/2-point complex
transform with K1's split and K2's merge. Bins are in natural order; that
is also the unordered layout at these sizes, as in the JAX package. Each
body has a plain version here, independent of the kernels' algorithm: the
direct DFT as matrix products over ``tables.small_tables_c/r/ri``
(float32 roots built in float64), accumulated in float64 and rounded once
to float32. A wrapper runs the plain version for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Domain (``in_domain``): 8 <= N <= 256, and the {2,3,5}-smooth sizes below
512 that are not multiples of 128 (the JAX package's ``_small_dispatch``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..plans import FFT_COMPLEX, FFT_REAL, FFTPlan
from ._cuda import MAX_SMALL_N, Kernel, check, launch, require_domain, takes_plain
from .hopper_cfft import as_complex, complex_io, like, shape_of
from .tables import is_smooth_multiple, small_tables_c, small_tables_r, small_tables_ri

__all__ = [
    "K5_COMPLEX",
    "K5_REAL",
    "K5_REAL_INVERSE",
    "MAX_SMALL_N",
    "TILE_POINTS",
    "POINTS_PER_THREAD",
    "Geometry",
    "in_domain",
    "launch_geometry",
    "small_cfft_kernel",
    "small_rfft_kernel",
    "small_irfft_kernel",
    "small_cfft_plain",
    "small_rfft_plain",
    "small_irfft_plain",
]

MIN_SMALL = 8
MAX_SMALL = 256
# Complex points a tile aims at (the largest power-of-two number of rows
# that fits), and points per thread (csrc/small_fft.cu kPerThread, which
# the library reports as hopper_small_fft_points_per_thread): 64 threads
# hold a 512-point tile's loads in flight at once, and two padded buffers
# of 8.4 KB let 18-20 blocks share an SM. Chosen by measurement on the
# H100 against tiles of 256, 1024 and 2048 points (PERF.md).
TILE_POINTS = 512
POINTS_PER_THREAD = 8

_SRC = "chowdsp_fft_tpu_torch/csrc/small_fft.cu"
_JAX = "chowdsp_fft_tpu/ops/pallas_fft.py"
K5_COMPLEX = Kernel("small_cfft_kernel", _SRC, f"{_JAX}:2299 (_small_cfft_kernel, via _small_call :2252)")
K5_REAL = Kernel("small_rfft_kernel", _SRC, f"{_JAX}:2310 (_small_rfft_kernel, via _small_call :2252)")
K5_REAL_INVERSE = Kernel("small_irfft_kernel", _SRC, f"{_JAX}:2319 (_small_irfft_kernel, via _small_call :2252)")


def in_domain(n: int) -> bool:
    """Everything from 8 up to 256, plus the sizes below 512 that are not
    smooth multiples of 128 (no Stockham kernel serves those)."""
    if n <= MAX_SMALL:
        return n >= MIN_SMALL
    return n <= MAX_SMALL_N and not is_smooth_multiple(n)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A K5 launch: tiles of ``2^shift`` rows, ``threads`` per block,
    ``smem_bytes`` of dynamic shared memory (two padded buffers of the
    tile's points, one float2 of padding per 32), ``grid`` blocks."""

    shift: int
    threads: int
    smem_bytes: int
    grid: int

    @property
    def tile_rows(self) -> int:
        return 1 << self.shift

    @property
    def args(self) -> tuple[int, int, int, int]:
        """The C entries' trailing geometry arguments."""
        return self.shift, self.threads, self.smem_bytes, self.grid


def launch_geometry(n: int, kind: str, rows: int) -> Geometry:
    """The launch of a K5 body on ``rows`` rows of an N-point ``kind``
    transform: the largest power-of-two tile of rows whose M-point
    transforms (M = N complex, N/2 real) hold at most ``TILE_POINTS``
    points, ``POINTS_PER_THREAD`` points a thread in whole warps (at least
    two), and a block per tile (the last one ragged). The C entries check
    it again."""
    m = n if kind == FFT_COMPLEX else n // 2
    shift = 0
    while m << (shift + 1) <= TILE_POINTS:
        shift += 1
    pts = m << shift
    threads = max(64, -(-pts // (32 * POINTS_PER_THREAD)) * 32)
    smem = 2 * (pts + (pts >> 5)) * 8
    return Geometry(shift, threads, smem, (rows + (1 << shift) - 1) >> shift)


def _launch(kernel: Kernel, entry: str, plan: FFTPlan, device: torch.device, rows: int, *args):
    """Launch a K5 entry: ``args``, then the plan's radices (host int
    array), stage twiddles (and split twiddles for a real plan), then the
    launch geometry."""
    tabs = plan.device_tables(device)
    radices = (ctypes.c_int * len(plan.radices))(*plan.radices)
    split = () if tabs.split_tw is None else (tabs.split_tw.data_ptr(),)
    launch(kernel, entry, device, *args, ctypes.addressof(radices), len(plan.radices),
           tabs.stage_flat.data_ptr(), *split, *launch_geometry(plan.n, plan.kind, rows).args)


@functools.lru_cache(maxsize=64)
def _device_matrices(table, n: int, device: str, *args) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 table values, held as float64 on ``device``."""
    return tuple(torch.from_numpy(a.astype("float64")).to(device) for a in table(n, *args))


# ---------------------------------------------------------------------------
# Plain versions: the direct DFT as matrix products, float64 accumulation
# ---------------------------------------------------------------------------


def small_cfft_plain(x, plan: FFTPlan, forward: bool = True):
    """Plain version of the complex body: the 4-product schoolbook."""
    z = as_complex(x)
    wr, wi = _device_matrices(small_tables_c, plan.n, str(z.device), forward)
    xr, xi = z.real.double(), z.imag.double()
    y = torch.complex((xr @ wr - xi @ wi).float(), (xr @ wi + xi @ wr).float())
    return like(x, y)


def small_rfft_plain(x: torch.Tensor, plan: FFTPlan):
    """Plain version of the real-forward body: (rows, N) -> packed planes."""
    cr, ci = _device_matrices(small_tables_r, plan.n, str(x.device))
    x = x.double()
    return (x @ cr).float(), (x @ ci).float()


def small_irfft_plain(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan):
    """Plain version of the real-inverse body: packed planes -> (rows, N)."""
    dr, di = _device_matrices(small_tables_ri, plan.n, str(yre.device))
    return (yre.double() @ dr + yim.double() @ di).float()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def small_cfft_kernel(x, plan: FFTPlan, forward: bool = True):
    """K5 complex body on (rows, N) complex64 or a (re, im) pair of planes."""
    require_domain(K5_COMPLEX, plan.kind == FFT_COMPLEX and in_domain(plan.n), plan.n, plan.kind)
    if takes_plain(K5_COMPLEX.name, x):
        return small_cfft_plain(x, plan, forward)
    rows = shape_of(x)[0]
    dev, stride, src, out, dst = complex_io(K5_COMPLEX.name, x, (rows, plan.n))
    if rows:
        _launch(K5_COMPLEX, "k5_small_cfft", plan, dev, rows, *src, *dst, stride, rows, plan.n,
                -1 if forward else 1)
    return out


def small_rfft_kernel(x: torch.Tensor, plan: FFTPlan):
    """K5 real-forward body: (rows, N) f32 -> ((rows, N/2), (rows, N/2))."""
    require_domain(K5_REAL, plan.kind == FFT_REAL and in_domain(plan.n), plan.n, plan.kind)
    if takes_plain(K5_REAL.name, x):
        return small_rfft_plain(x, plan)
    rows, n = x.shape[0], plan.n
    check("x", x, (rows, n), x.device)
    yre = torch.empty((rows, n // 2), dtype=torch.float32, device=x.device)
    yim = torch.empty_like(yre)
    if rows:
        _launch(K5_REAL, "k5_small_rfft", plan, x.device, rows, x.data_ptr(), yre.data_ptr(), yim.data_ptr(),
                rows, n)
    return yre, yim


def small_irfft_kernel(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan):
    """K5 real-inverse body: packed planes (rows, N/2) x2 -> (rows, N) f32."""
    require_domain(K5_REAL_INVERSE, plan.kind == FFT_REAL and in_domain(plan.n), plan.n, plan.kind)
    if takes_plain(K5_REAL_INVERSE.name, yre, yim):
        return small_irfft_plain(yre, yim, plan)
    rows, n = yre.shape[0], plan.n
    check("yre", yre, (rows, n // 2), yre.device)
    check("yim", yim, (rows, n // 2), yre.device)
    x = torch.empty((rows, n), dtype=torch.float32, device=yre.device)
    if rows:
        _launch(K5_REAL_INVERSE, "k5_small_irfft", plan, yre.device, rows, yre.data_ptr(), yim.data_ptr(),
                x.data_ptr(), rows, n)
    return x
