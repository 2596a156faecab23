"""Hopper engine: the transforms on hand-written CUDA kernels (counterpart
of ``chowdsp_fft_tpu/ops/pallas_fft.py``'s engine registration and
dispatch).

Four kernel families, each checking its own size domain:

- K1-K3 (``csrc/real_fft.cu``, this module): the packed real FFT, its
  inverse and the fused spectral product + inverse, for real
  N = n1 * 128 with n1 {2,3,5}-smooth and 256 < N <= MAX_N;
- K4 (``csrc/complex_fft.cu``, ``hopper_cfft``): the complex FFT for
  N = n1 * 128, 256 < N <= MAX_CN;
- K5 (``csrc/small_fft.cu``, ``hopper_small``): row-tiled mixed-radix
  FFTs, complex and real, for 8 <= N <= 256 and the smooth non-multiples
  of 128 below 512;
- K6, K7a, K7b (``csrc/composite_fft.cu``, ``hopper_composite``): the
  two-level composite, complex and real, for every other size the JAX
  ``pallas`` engine serves, up to 2^20;
- K1-db, K2-db (this module) and K4-db (``hopper_cfft``)
  (``csrc/pipelined_fft.cu``): the pipelined forms of K1, K2 and K4,
  persistent blocks that load the next row while the current one
  computes, bit-identical to their grid kernels on the same domains. As
  in the JAX package, no dispatch path runs them (only its tests call its
  ``_db`` functions); ``auto`` and ``hopper`` run the grid kernels.

The engine serves exactly the JAX engine's domain (``supports_plan``) and
``auto`` prefers it where the JAX engine is preferred (``prefers``). Each
kernel has a plain PyTorch version built from the same tables and the
same layout. A wrapper runs the plain version for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. Layouts are the JAX
package's: packed planes with DC in re[0] and Nyquist in im[0]; the real
unordered layout (position k1*64 + k2 holds bin k1 + N1*k2) on K1-K3, the
complex one (k1*128 + k2) on K4, natural order on K5 and the composite.

Shared memory bounds the single-row kernels (K1-K4 on the row engine,
``row_passes``): a row's two padded buffers take 8.25N bytes for a real
row (132 KB at MAX_N = 16384) and 16.5N bytes for a complex one (223 KB
at MAX_CN = 13824), of the 227 KB a block may use. Above those sizes the
composite runs its columns in tiles that fit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import api as _api
from ..plans import FFT_COMPLEX, FFT_FORWARD, FFT_REAL, FFTPlan, cached_plan
from . import autodiff, hopper_cfft, hopper_composite, hopper_small, row_passes, stockham
from ._cuda import MAX_CN, MAX_N, Kernel, check as _check, device_perm, host_ints, launch, require_domain, takes_plain
from .convolve import convolve_accumulate_packed, convolve_accumulate_packed_plain
from .layout import packed_planes_to_spectrum, spectrum_to_packed_planes
from .tables import (
    JAX_MAX_N,
    JAX_MAX_SMALL_FALLBACK,
    JAX_MIN_SMALL,
    LANES,
    inverse_perm,
    is_smooth_multiple,
    jax_has_composite_split,
    jax_small_dispatch,
    unordered_perm,
)

__all__ = [
    "MAX_N",
    "MAX_CN",
    "KERNELS",
    "supports_plan",
    "prefers",
    "merge_precision",
    "rfft_packed",
    "irfft_packed",
    "convolve_irfft_packed",
    "cfft",
    "cfft_planes",
    "rfft_rows",
    "irfft_rows",
    "rfft_packed_kernel",
    "irfft_packed_kernel",
    "convolve_irfft_packed_kernel",
    "rfft_packed_plain",
    "irfft_packed_plain",
    "convolve_irfft_packed_plain",
    "rfft_packed_joint_kernel",
    "rfft_packed_joint_db_kernel",
    "irfft_packed_db_kernel",
    "rfft_packed_joint_plain",
]

MIN_N = 2 * LANES  # exclusive: real N <= 256 goes to K5


K1 = Kernel(
    "rfft_packed_kernel",
    "chowdsp_fft_tpu_torch/csrc/real_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:1078 (_rfft_kernel)",
)
K2 = Kernel(
    "irfft_packed_kernel",
    "chowdsp_fft_tpu_torch/csrc/real_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:1111 (_irfft_kernel)",
)
K3 = Kernel(
    "convolve_irfft_packed_kernel",
    "chowdsp_fft_tpu_torch/csrc/real_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:1989 (_irfft_conv_kernel)",
)
K1_DB = Kernel(
    "rfft_packed_joint_db_kernel",
    "chowdsp_fft_tpu_torch/csrc/pipelined_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:1628 (_rfft_db_kernel, called by _rfft_packed_joint_db :1731)",
)
K2_DB = Kernel(
    "irfft_packed_db_kernel",
    "chowdsp_fft_tpu_torch/csrc/pipelined_fft.cu",
    "chowdsp_fft_tpu/ops/pallas_fft.py:1756 (_irfft_db_kernel, called by _irfft_packed_db :1863)",
)
K4 = hopper_cfft.K4
KERNELS = (K1, K2, K3, K4, hopper_small.K5_COMPLEX, hopper_small.K5_REAL, hopper_small.K5_REAL_INVERSE,
           *hopper_composite.KERNELS, K1_DB, K2_DB, hopper_cfft.K4_DB)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Merge precision
# ---------------------------------------------------------------------------

# The mode's carrier is PyTorch's ambient float32 matmul precision, as the
# JAX package's is jax.default_matmul_precision: a precision that already
# allows reduced-precision passes ("high", "medium") reads as "bf16x3".
_MERGE_CARRIER = {"highest": "highest", "bf16x3": "high"}
_MODE_OF_CARRIER = {"highest": "highest", "high": "bf16x3", "medium": "bf16x3"}


def _merge_mode() -> str:
    """The merge mode the ambient float32 matmul precision selects."""
    carrier = torch.get_float32_matmul_precision()
    mode = _MODE_OF_CARRIER.get(carrier)
    if mode is None:
        raise ValueError(f"float32 matmul precision {carrier!r} selects no merge precision")
    return mode


@contextlib.contextmanager
def _matmul_precision(carrier: str):
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(carrier)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def merge_precision(mode: str):
    """Context manager selecting the merge mode ("highest" | "bf16x3") for
    the transforms run inside it, the JAX package's speed/accuracy opt-in
    (its bf16x3 mode replaces the MXU merge's six passes with three bf16
    passes).

    The Hopper kernels have no matmul merge to relax: their butterflies
    are FP32 FMAs throughout, and they ignore the mode, so under either
    mode the port's transforms give the same output, within 2e-7*N of
    float64. The mode is carried as it is in JAX, by the ambient
    precision: "bf16x3" sets ``torch.set_float32_matmul_precision("high")``
    for the context, "highest" sets "highest", and the caller's setting
    comes back on exit, also on an exception. Side effect, as in JAX:
    other float32 matmuls inside the context follow that precision ("high"
    allows TF32 on the card)."""
    if mode not in _MERGE_CARRIER:
        raise ValueError(f"unknown merge precision {mode!r}")
    return _matmul_precision(_MERGE_CARRIER[mode])


# ---------------------------------------------------------------------------
# Domain
# ---------------------------------------------------------------------------


def _in_domain(n: int) -> bool:
    """The K1-K3 domain: real N = n1*128, n1 {2,3,5}-smooth, 256 < N <= MAX_N."""
    return MIN_N < n <= MAX_N and is_smooth_multiple(n)


def supports_plan(plan: FFTPlan) -> bool:
    """The JAX engine's ``supports_plan`` (pallas_fft.py:185), size for
    size and kind for kind: the small-N sizes (K5), the single-kernel
    sizes up to 2^17 (K1-K4 up to MAX_N/MAX_CN, the composite above) and
    every composite split up to 2^20 (real plans need both factors even),
    including the medium smooth non-multiples of 128 (576, 720, ...)."""
    n = plan.n
    if jax_small_dispatch(n):
        return True
    if n < JAX_MIN_SMALL:
        return False
    if n <= JAX_MAX_N and is_smooth_multiple(n):
        return True
    return jax_has_composite_split(n, real=plan.kind == FFT_REAL)


def prefers(plan: FFTPlan) -> bool:
    """What ``engine="auto"`` hands this engine: the JAX ``prefer_plan``
    (pallas_fft.py:205), i.e. ``supports_plan`` without the medium smooth
    non-multiples of 128 above 511, which go to the Stockham engine."""
    return supports_plan(plan) and (plan.n <= JAX_MAX_SMALL_FALLBACK or plan.n % LANES == 0)


# ---------------------------------------------------------------------------
# K1-K3 plain versions: the kernels' math in plain PyTorch, same tables, same layout
# ---------------------------------------------------------------------------


def rfft_packed_plain(x: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """Plain version of K1: (rows, N) f32 -> packed planes, ordered or unordered."""
    re, im = spectrum_to_packed_planes(stockham.rfft(x, plan))
    if not ordered:
        perm = device_perm(unordered_perm, plan.n, str(x.device))
        re, im = re[..., perm], im[..., perm]
    return re, im


def irfft_packed_plain(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """Plain version of K2: packed planes -> (rows, N) f32, unscaled."""
    if not ordered:
        inv = device_perm(inverse_perm, plan.n, str(yre.device))
        yre, yim = yre[..., inv], yim[..., inv]
    return stockham.irfft(packed_planes_to_spectrum(yre, yim), plan)


def convolve_irfft_packed_plain(are, aim, bre, bim, scale: float, plan: FFTPlan, ordered: bool = True):
    """Plain version of K3: irfft(scale * A (.) B) with the bin-0 patch-up."""
    pr, pi = convolve_accumulate_packed_plain((are, aim), (bre, bim), scaling=scale)
    return irfft_packed_plain(pr, pi, plan, ordered)


def rfft_packed_joint_plain(x: torch.Tensor, plan: FFTPlan, ordered: bool = True) -> torch.Tensor:
    """Plain version of K1's joint form and of K1-db: (rows, N) ->
    (rows, N) rows [re | im] (JAX's ``_rfft_packed_joint``)."""
    return torch.cat(rfft_packed_plain(x, plan, ordered), dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _launch_rows(kernel: Kernel, entry: str, plan: FFTPlan, device: torch.device, ordered: bool, rows: int,
                 *args, position_split: bool, grid: bool):
    """Launch a row-engine entry of K1-K3 or their db forms with ``args``
    (the kernel's tensors and scalars, ending in rows and N) followed by
    the plan's radices and pass plan (host int arrays), the pass twiddles
    and the split twiddles (complex64 on the device, i.e. float2;
    ``row_passes.device_tables``), the unordered permutation (NULL for
    ordered bins) and, for a grid form (``grid``), the launch geometry
    (``row_passes.launch_geometry``; a pipelined form picks its persistent
    grid). The split twiddles are in bin order (the inverse's merge), or
    with ``position_split`` in position order (K1's epilogue: gathered to
    the unordered layout)."""
    tw, split_unordered = row_passes.device_tables(plan.n, plan.kind, str(device))
    split = split_unordered if position_split and not ordered else plan.device_tables(device).split_tw
    perm = None if ordered else device_perm(unordered_perm, plan.n, str(device)).data_ptr()
    geo = row_passes.launch_geometry(plan, rows)
    launch(kernel, entry, device, *args, ctypes.addressof(host_ints(plan.radices)), len(plan.radices),
           ctypes.addressof(host_ints(geo.flat_passes)), len(geo.passes), tw.data_ptr(), split.data_ptr(), perm,
           *(geo.args if grid else ()))


def _require_real_domain(kernel: Kernel, plan: FFTPlan):
    require_domain(kernel, plan.kind == FFT_REAL and _in_domain(plan.n), plan.n, plan.kind)


def rfft_packed_kernel(x: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """K1 on (rows, N) f32 -> ((rows, N/2), (rows, N/2)) f32."""
    _require_real_domain(K1, plan)
    if takes_plain(K1.name, x):
        return rfft_packed_plain(x, plan, ordered)
    rows = x.shape[0]
    _check("x", x, (rows, plan.n), x.device)
    yre = torch.empty((rows, plan.n // 2), dtype=torch.float32, device=x.device)
    yim = torch.empty_like(yre)
    if rows:
        _launch_rows(K1, "k1_rfft_packed", plan, x.device, ordered, rows,
                     x.data_ptr(), yre.data_ptr(), yim.data_ptr(), plan.n // 2, rows, plan.n,
                     position_split=True, grid=True)
    return yre, yim


def _rfft_joint(kernel: Kernel, entry: str, x: torch.Tensor, plan: FFTPlan, ordered: bool, align: int,
                grid: bool):
    """K1 (``grid``) or K1-db into joint rows: re at [0, N/2), im at
    [N/2, N), row stride N."""
    _require_real_domain(kernel, plan)
    if takes_plain(kernel.name, x):
        return rfft_packed_joint_plain(x, plan, ordered)
    rows, n = x.shape[0], plan.n
    _check("x", x, (rows, n), x.device, align=align)
    y = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows:
        _launch_rows(kernel, entry, plan, x.device, ordered, rows,
                     x.data_ptr(), y.data_ptr(), y.data_ptr() + 4 * (n // 2), n, rows, n,
                     position_split=True, grid=grid)
    return y


def rfft_packed_joint_kernel(x: torch.Tensor, plan: FFTPlan, ordered: bool = True) -> torch.Tensor:
    """K1 with the joint output of JAX's ``_rfft_packed_joint``: (rows, N)
    f32 -> (rows, N) rows [re | im], Nyquist in im[0]."""
    return _rfft_joint(K1, "k1_rfft_packed", x, plan, ordered, 8, grid=True)


def rfft_packed_joint_db_kernel(x: torch.Tensor, plan: FFTPlan, ordered: bool = True) -> torch.Tensor:
    """K1-db, the pipelined K1 (JAX's ``_rfft_packed_joint_db``): the same
    joint rows, bit-identical to :func:`rfft_packed_joint_kernel`. The
    input must be 16-byte aligned."""
    return _rfft_joint(K1_DB, "k1db_rfft_packed", x, plan, ordered, 16, grid=False)


def _irfft(kernel: Kernel, entry: str, yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool,
           align: int, grid: bool):
    """K2 (``grid``) or K2-db: packed planes (rows, N/2) x2 -> (rows, N) f32."""
    _require_real_domain(kernel, plan)
    if takes_plain(kernel.name, yre, yim):
        return irfft_packed_plain(yre, yim, plan, ordered)
    rows = yre.shape[0]
    _check("yre", yre, (rows, plan.n // 2), yre.device, align=align)
    _check("yim", yim, (rows, plan.n // 2), yre.device, align=align)
    x = torch.empty((rows, plan.n), dtype=torch.float32, device=yre.device)
    if rows:
        _launch_rows(kernel, entry, plan, yre.device, ordered, rows,
                     yre.data_ptr(), yim.data_ptr(), x.data_ptr(), rows, plan.n, position_split=False, grid=grid)
    return x


def irfft_packed_kernel(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """K2 on packed planes (rows, N/2) x2 -> (rows, N) f32."""
    return _irfft(K2, "k2_irfft_packed", yre, yim, plan, ordered, 8, grid=True)


def irfft_packed_db_kernel(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """K2-db, the pipelined K2 (JAX's ``_irfft_packed_db``): bit-identical
    to :func:`irfft_packed_kernel`. The planes must be 16-byte aligned."""
    return _irfft(K2_DB, "k2db_irfft_packed", yre, yim, plan, ordered, 16, grid=False)


def convolve_irfft_packed_kernel(are, aim, bre, bim, scale: float, plan: FFTPlan, ordered: bool = True):
    """K3: A (rows, N/2) x2, B (1 or rows, N/2) x2 -> irfft(scale * A (.) B)."""
    _require_real_domain(K3, plan)
    if takes_plain(K3.name, are, aim, bre, bim):
        return convolve_irfft_packed_plain(are, aim, bre, bim, scale, plan, ordered)
    rows, b_rows = are.shape[0], bre.shape[0]
    if b_rows not in (1, rows):
        raise ValueError(f"B batch {b_rows} must be 1 or match A batch {rows}")
    m = plan.n // 2
    _check("are", are, (rows, m), are.device)
    _check("aim", aim, (rows, m), are.device)
    _check("bre", bre, (b_rows, m), are.device)
    _check("bim", bim, (b_rows, m), are.device)
    x = torch.empty((rows, plan.n), dtype=torch.float32, device=are.device)
    if rows:
        _launch_rows(K3, "k3_convolve_irfft_packed", plan, are.device, ordered, rows,
                     are.data_ptr(), aim.data_ptr(), bre.data_ptr(), bim.data_ptr(),
                     b_rows, float(scale), x.data_ptr(), rows, plan.n, position_split=False, grid=True)
    return x


# ---------------------------------------------------------------------------
# Engine entry points (same signatures as the Stockham engine's)
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, width: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., width) -> contiguous, 8-byte aligned (rows, width) rows, with
    a lazy conjugate or negative view (``z.conj()``) made real: the
    kernels read the memory as it lies."""
    t = t.to(dtype).reshape(-1, width).resolve_conj().resolve_neg().contiguous()
    return t.clone() if t.data_ptr() % 8 else t


def _plan_for(n: int, plan: FFTPlan | None, kind: str = FFT_REAL) -> FFTPlan:
    plan = plan or cached_plan(n, kind)
    if plan.kind != kind or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), {kind} N={n}")
    return plan


def rfft_rows(x: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """The real forward dispatch on (rows, N) f32 rows -> packed planes:
    K5 for its sizes, K1 in its domain, the composite above."""
    n = plan.n
    if hopper_small.in_domain(n):
        return hopper_small.small_rfft_kernel(x, plan)
    if _in_domain(n):
        return rfft_packed_kernel(x, plan, ordered)
    return hopper_composite.rfft_composite(x, plan)


def irfft_rows(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """The real inverse dispatch on packed planes (rows, N/2) x2 -> (rows,
    N) f32, unscaled: K5, K2 or the composite."""
    n = plan.n
    if hopper_small.in_domain(n):
        return hopper_small.small_irfft_kernel(yre, yim, plan)
    if _in_domain(n):
        return irfft_packed_kernel(yre, yim, plan, ordered)
    return hopper_composite.irfft_composite(yre, yim, plan)


def rfft_packed(x: torch.Tensor, plan: FFTPlan | None = None, ordered: bool = True):
    """Real FFT -> packed half-spectrum planes ((..., N/2) f32 x2): K5,
    then K1 up to MAX_N, then the composite; K5 and composite sizes are in
    natural order either way. An input that requires grad (in grad mode)
    goes through ``autodiff.RfftPacked``, whose backward runs the inverse
    kernels."""
    n = x.shape[-1]
    plan = _plan_for(n, plan)
    batch_shape = x.shape[:-1]
    rows = _rows(x, n)
    if autodiff.needs_grad(rows):
        yre, yim = autodiff.RfftPacked.apply(rows, plan, ordered)
    else:
        yre, yim = rfft_rows(rows, plan, ordered)
    return yre.reshape(*batch_shape, n // 2), yim.reshape(*batch_shape, n // 2)


def irfft_packed(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan | None = None, ordered: bool = True):
    """Unscaled inverse of :func:`rfft_packed` -> (..., N) f32 (through
    ``autodiff.IrfftPacked`` when an input requires grad)."""
    m = yre.shape[-1]
    plan = _plan_for(2 * m, plan)
    batch_shape = yre.shape[:-1]
    rows = _rows(yre, m), _rows(yim, m)
    if autodiff.needs_grad(*rows):
        x = autodiff.IrfftPacked.apply(*rows, plan, ordered)
    else:
        x = irfft_rows(*rows, plan, ordered)
    return x.reshape(*batch_shape, 2 * m)


def convolve_irfft_packed(are, aim, bre, bim, plan: FFTPlan | None = None, scaling=1.0, ordered: bool = True):
    """Fused ``irfft_packed(A (.) B * scaling)``: the product spectrum
    never reaches device memory. A is (..., N/2) packed planes; B matches
    A's batch or is one shared spectrum (a filter). The fused kernel (K3)
    serves the K1 domain with a number ``scaling`` (through
    ``autodiff.ConvolveIrfftPacked`` when an input requires grad); a
    tensor ``scaling``, a K5 size or a composite size takes the unfused
    composition (same math), as the JAX package's gate does
    (pallas_fft.py:2151-2159)."""
    m = are.shape[-1]
    plan = _plan_for(2 * m, plan)
    if isinstance(scaling, torch.Tensor) or not _in_domain(plan.n):
        pr, pi = convolve_accumulate_packed((are, aim), (bre, bim), scaling=scaling)
        return irfft_packed(pr, pi, plan, ordered)
    batch_shape = are.shape[:-1]
    rows = _rows(are, m), _rows(aim, m), _rows(bre, m), _rows(bim, m)
    if rows[2].shape[0] not in (1, rows[0].shape[0]):
        raise ValueError(f"B batch {rows[2].shape[0]} must be 1 or match A batch {rows[0].shape[0]}")
    if autodiff.needs_grad(*rows):
        x = autodiff.ConvolveIrfftPacked.apply(*rows, plan, float(scaling), ordered)
    else:
        x = convolve_irfft_packed_kernel(*rows, float(scaling), plan, ordered)
    return x.reshape(*batch_shape, 2 * m)


def rfft(x, plan=None):
    """Real FFT -> canonical (..., N//2+1) complex64 spectrum."""
    return packed_planes_to_spectrum(*rfft_packed(x, plan))


def irfft(spec, plan=None):
    """Unscaled inverse real FFT from a canonical complex spectrum."""
    return irfft_packed(*spectrum_to_packed_planes(spec), plan)


def rfft_canonical_unordered(x, plan=None):
    """Canonical-type spectrum in the engine's unordered bin order, the
    Nyquist bin appended last (bin 0 is index 0 in every layout, so the
    packed-plane converters apply unchanged)."""
    return packed_planes_to_spectrum(*rfft_packed(x, plan, ordered=False))


def irfft_canonical_unordered(spec, plan=None):
    return irfft_packed(*spectrum_to_packed_planes(spec), plan, ordered=False)


def _rfft_packed_unordered(x, plan=None):
    return rfft_packed(x, plan, ordered=False)


def _irfft_packed_unordered(yre, yim, plan=None):
    return irfft_packed(yre, yim, plan, ordered=False)


def cfft(x: torch.Tensor, plan: FFTPlan | None = None, direction: str = FFT_FORWARD, ordered: bool = True):
    """Complex FFT over the last axis, unscaled: (..., N) -> (..., N)
    complex64: K5, K4 up to MAX_CN, then the composite
    (``hopper_composite.cfft_rows``). The kernels read the complex64 rows
    in place as float2."""
    n = x.shape[-1]
    plan = _plan_for(n, plan, FFT_COMPLEX)
    rows = _rows(x, n, torch.complex64)
    if autodiff.needs_grad(rows):
        y = autodiff.CfftPair.apply(rows, None, plan, direction == FFT_FORWARD, ordered)
    else:
        y = hopper_composite.cfft_rows(rows, plan, direction == FFT_FORWARD, ordered)
    return y.reshape(*x.shape[:-1], n)


def cfft_planes(re: torch.Tensor, im: torch.Tensor, plan: FFTPlan | None = None,
                direction: str = FFT_FORWARD, ordered: bool = True):
    """Complex FFT on SoA float32 planes -> (re, im) planes."""
    n = re.shape[-1]
    plan = _plan_for(n, plan, FFT_COMPLEX)
    rows = _rows(re, n), _rows(im, n)
    if autodiff.needs_grad(*rows):
        yre, yim = autodiff.CfftPair.apply(*rows, plan, direction == FFT_FORWARD, ordered)
    else:
        yre, yim = hopper_composite.cfft_rows(rows, plan, direction == FFT_FORWARD, ordered)
    return yre.reshape(*re.shape[:-1], n), yim.reshape(*re.shape[:-1], n)


_api.register_engine(
    "hopper",
    {
        "cfft": cfft,
        "cfft_unordered": functools.partial(cfft, ordered=False),
        "cfft_planes": cfft_planes,
        "cfft_planes_unordered": functools.partial(cfft_planes, ordered=False),
        "rfft": rfft,
        "irfft": irfft,
        "rfft_unordered": rfft_canonical_unordered,
        "irfft_unordered": irfft_canonical_unordered,
        "rfft_packed": rfft_packed,
        "irfft_packed": irfft_packed,
        "rfft_packed_unordered": _rfft_packed_unordered,
        "irfft_packed_unordered": _irfft_packed_unordered,
        "convolve_irfft_packed": convolve_irfft_packed,
    },
    supports=supports_plan,
    prefers=prefers,
)
