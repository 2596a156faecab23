"""K4: the complex FFT on a hand-written CUDA kernel (``csrc/complex_fft.cu``),
counterpart of ``_pallas_cfft_pair`` in ``chowdsp_fft_tpu/ops/pallas_fft.py``.

``cfft_kernel`` transforms (rows, N) complex rows, given either as one
complex64 tensor (read as interleaved float2, no copy) or as a (re, im)
pair of float32 planes, and returns the same form. Forward or backward,
unscaled, ordered bins or the JAX package's unordered layout
(``tables.cfft_unordered_perm``: position k1*128 + k2 holds bin
k1 + N1*k2). Its plain version, ``cfft_plain``, is the Stockham engine's
complex transform followed (forward) or preceded (backward) by the same
permutation. The wrapper runs the plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises.

Domain: N = n1 * 128, n1 {2,3,5}-smooth, 256 < N <= MAX_CN = 13824. The
kernel runs the register-resident pass engine shared with K1
(``csrc/row_passes.cuh``; launch geometry from
``row_passes.launch_geometry``).

``cfft_db_kernel`` is K4-db (``csrc/pipelined_fft.cu``), the pipelined
form of K4 (JAX's ``_cfft_pair_db``): the same forms, modes and domain,
bit-identical output, persistent blocks that load the next row while the
current one computes. No dispatch path runs it.
"""

from __future__ import annotations

import ctypes

import torch

from ..plans import FFT_BACKWARD, FFT_COMPLEX, FFT_FORWARD, FFTPlan
from . import row_passes, stockham
from ._cuda import MAX_CN, Kernel, check, device_perm, host_ints, launch, require_domain, takes_plain
from .tables import LANES, cfft_inverse_perm, cfft_unordered_perm, is_smooth_multiple

__all__ = ["K4", "K4_DB", "MAX_CN", "in_domain", "cfft_kernel", "cfft_db_kernel", "cfft_plain"]

K4 = Kernel(
    "cfft_kernel",
    "chowdsp_fft_tpu_torch/csrc/complex_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:620 (_fft_kernel, called by _pallas_cfft_pair :648)",
)
K4_DB = Kernel(
    "cfft_db_kernel",
    "chowdsp_fft_tpu_torch/csrc/pipelined_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:739 (_cfft_db_kernel, called by _cfft_pair_db :867)",
)


def in_domain(n: int) -> bool:
    """N = n1*128, n1 {2,3,5}-smooth, 256 < N <= MAX_CN."""
    return 2 * LANES < n <= MAX_CN and is_smooth_multiple(n)


# ---------------------------------------------------------------------------
# Complex rows in either form: one complex64 tensor or a (re, im) pair
# ---------------------------------------------------------------------------


def as_complex(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.complex(x[0], x[1])


def like(x, z: torch.Tensor):
    """``z`` (complex) in the form of ``x``."""
    return z if isinstance(x, torch.Tensor) else (z.real.contiguous(), z.imag.contiguous())


def shape_of(x) -> tuple[int, ...]:
    return tuple((x if isinstance(x, torch.Tensor) else x[0]).shape)


def complex_io(name: str, x, shape, out_shape=None, align: int = 8):
    """Check the input, complex data of ``shape`` ((rows, N) rows; the
    composite's (B, L, M) tiles), and allocate the output, of ``out_shape``
    (default ``shape``) in ``x``'s form. Returns (device, element stride,
    input (re, im) pointers, output, output (re, im) pointers). A complex64
    tensor is read as interleaved float2: stride 2, the imaginary part one
    float after the real part."""
    out_shape = shape if out_shape is None else out_shape
    if isinstance(x, torch.Tensor):
        check(name, x, shape, x.device, torch.complex64, align)
        y = torch.empty(out_shape, dtype=torch.complex64, device=x.device)
        xp, yp = x.data_ptr(), y.data_ptr()
        return x.device, 2, (xp, xp + 4), y, (yp, yp + 4)
    re, im = x
    check(f"{name} re", re, shape, re.device, align=align)
    check(f"{name} im", im, shape, re.device, align=align)
    yre = torch.empty(out_shape, dtype=torch.float32, device=re.device)
    yim = torch.empty_like(yre)
    return re.device, 1, (re.data_ptr(), im.data_ptr()), (yre, yim), (yre.data_ptr(), yim.data_ptr())


# ---------------------------------------------------------------------------
# K4 and its plain version
# ---------------------------------------------------------------------------


def cfft_plain(x, plan: FFTPlan, forward: bool = True, ordered: bool = True):
    """Plain version of K4: the Stockham complex transform, with the
    unordered permutation gathered after (forward) or undone before
    (backward)."""
    z = as_complex(x)
    if not forward and not ordered:
        z = z[..., device_perm(cfft_inverse_perm, plan.n, str(z.device))]
    y = stockham.cfft(z, plan, FFT_FORWARD if forward else FFT_BACKWARD)
    if forward and not ordered:
        y = y[..., device_perm(cfft_unordered_perm, plan.n, str(y.device))]
    return like(x, y)


def _cfft(kernel: Kernel, entry: str, x, plan: FFTPlan, forward: bool, ordered: bool, align: int):
    require_domain(kernel, plan.kind == FFT_COMPLEX and in_domain(plan.n), plan.n, plan.kind)
    if takes_plain(kernel.name, x):
        return cfft_plain(x, plan, forward, ordered)
    rows = shape_of(x)[0]
    dev, stride, src, out, dst = complex_io(kernel.name, x, (rows, plan.n), align=align)
    if rows:
        tw, _ = row_passes.device_tables(plan.n, plan.kind, str(dev))
        geo = row_passes.launch_geometry(plan, rows)
        perm = None if ordered else device_perm(cfft_unordered_perm, plan.n, str(dev)).data_ptr()
        tail = geo.args if kernel is K4 else ()  # K4-db picks its own persistent grid
        launch(kernel, entry, dev, *src, *dst, stride, rows, plan.n, -1 if forward else 1,
               ctypes.addressof(host_ints(plan.radices)), len(plan.radices),
               ctypes.addressof(host_ints(geo.flat_passes)), len(geo.passes), tw.data_ptr(), perm, *tail)
    return out


def cfft_kernel(x, plan: FFTPlan, forward: bool = True, ordered: bool = True):
    """K4 on (rows, N) complex64, or on a (re, im) pair of (rows, N)
    float32 planes; returns the same form."""
    return _cfft(K4, "k4_cfft", x, plan, forward, ordered, 8)


def cfft_db_kernel(x, plan: FFTPlan, forward: bool = True, ordered: bool = True):
    """K4-db: :func:`cfft_kernel`'s forms and modes (forward with
    unordered output is JAX's ``reverse_order=False``, backward with
    unordered input its ``reverse_order=True``), bit-identical output.
    The input must be 16-byte aligned."""
    return _cfft(K4_DB, "k4db_cfft", x, plan, forward, ordered, 16)
