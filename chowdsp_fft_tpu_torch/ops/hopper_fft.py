"""Hopper engine: the packed real FFT and fast-convolution path on
hand-written CUDA kernels (counterpart of the real-transform part of
``chowdsp_fft_tpu/ops/pallas_fft.py``).

Three kernels (``csrc/real_fft.cu``) carry the path:

- K1 ``rfft_packed_kernel``: (rows, N) f32 -> packed planes (rows, N/2) x2;
- K2 ``irfft_packed_kernel``: packed planes -> (rows, N) f32, unscaled;
- K3 ``convolve_irfft_packed_kernel``: irfft(scale * A (.) B) in one pass.

Each has a plain PyTorch twin here, built from the same plan tables and
the same unordered permutation (``tables.unordered_perm``). A wrapper runs
the twin for a tensor on the CPU; for a CUDA tensor it launches the kernel
or raises. Layouts are the JAX package's: packed planes with DC in re[0]
and Nyquist in im[0], ordered bins or the unordered layout (position
k1*64 + k2 holds bin k1 + N1*k2).

Domain: N = n1 * 128 with n1 {2,3,5}-smooth and 256 < N <= MAX_N. One
thread block holds a row's two shared-memory buffers (8.25N bytes, 132 KB
at MAX_N = 16384; a block may use 227 KB). ``auto`` sends every other
size to the Stockham engine.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import api as _api
from ..plans import FFT_REAL, FFTPlan, InvalidSizeError, cached_plan, factorize
from . import stockham
from .convolve import convolve_accumulate_packed
from .layout import packed_planes_to_spectrum, spectrum_to_packed_planes
from .tables import LANES, inverse_perm, unordered_perm

__all__ = [
    "MAX_N",
    "KERNELS",
    "supports_plan",
    "prefer_plan",
    "rfft_packed",
    "irfft_packed",
    "convolve_irfft_packed",
    "rfft_packed_kernel",
    "irfft_packed_kernel",
    "convolve_irfft_packed_kernel",
    "rfft_packed_plain",
    "irfft_packed_plain",
    "convolve_irfft_packed_plain",
]

MIN_N = 2 * LANES  # exclusive: N <= 256 goes to the Stockham engine
MAX_N = 16384  # must equal kMaxN in csrc/real_fft.cu


@dataclasses.dataclass
class Kernel:
    """A kernel's identity and its launch count (incremented once per
    launch of the CUDA kernel, never by the plain twin)."""

    name: str
    source: str
    replaces: str
    launches: int = 0


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
KERNELS = (K1, K2, K3)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Domain
# ---------------------------------------------------------------------------


def _in_domain(n: int) -> bool:
    if n % LANES or not MIN_N < n <= MAX_N:
        return False
    try:
        factorize(n // LANES)
    except InvalidSizeError:
        return False
    return True


def supports_plan(plan: FFTPlan) -> bool:
    """Real plans with N = n1*128, n1 {2,3,5}-smooth, 256 < N <= MAX_N.
    The complex surface is not on this engine yet."""
    return plan.kind == FFT_REAL and _in_domain(plan.n)


def prefer_plan(plan: FFTPlan) -> bool:
    """What ``engine="auto"`` hands this engine: everything it supports
    (no supported size has been measured slower than the Stockham
    engine)."""
    return supports_plan(plan)


# ---------------------------------------------------------------------------
# Plain twins: the kernels' math in plain PyTorch, same tables, same layout
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _device_perm(n: int, device: str, inverse: bool = False) -> torch.Tensor:
    """``tables.unordered_perm(n)`` (or its inverse) as an int32 tensor."""
    perm = inverse_perm(n) if inverse else unordered_perm(n)
    return torch.from_numpy(perm.copy()).to(device)


def rfft_packed_plain(x: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """Twin of K1: (rows, N) f32 -> packed planes, ordered or unordered."""
    re, im = spectrum_to_packed_planes(stockham.rfft(x, plan))
    if not ordered:
        perm = _device_perm(plan.n, str(x.device))
        re, im = re[..., perm], im[..., perm]
    return re, im


def irfft_packed_plain(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """Twin of K2: packed planes -> (rows, N) f32, unscaled."""
    if not ordered:
        inv = _device_perm(plan.n, str(yre.device), inverse=True)
        yre, yim = yre[..., inv], yim[..., inv]
    return stockham.irfft(packed_planes_to_spectrum(yre, yim), plan)


def convolve_irfft_packed_plain(are, aim, bre, bim, scale: float, plan: FFTPlan, ordered: bool = True):
    """Twin of K3: irfft(scale * A (.) B) with the bin-0 patch-up."""
    pr, pi = convolve_accumulate_packed((are, aim), (bre, bim), scaling=scale)
    return irfft_packed_plain(pr, pi, plan, ordered)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: expected 8-byte aligned data")
    if t.requires_grad:
        raise RuntimeError(
            f"{name}: the Hopper kernels have no autograd yet; detach the input "
            "explicitly or run on the CPU"
        )


def _launch(kernel: Kernel, entry: str, plan: FFTPlan, device: torch.device, ordered: bool, *args):
    """Launch ``entry`` on the current stream of ``device`` with ``args``
    followed by the plan's tables: radices (host int array), stage and
    split twiddles (complex64 on the device, i.e. float2), and the
    unordered permutation (int32 on the device, NULL for ordered bins)."""
    from ._cuda import library

    if not supports_plan(plan):
        raise ValueError(f"{kernel.name}: N={plan.n} is outside the kernel domain")
    tabs = plan.device_tables(device)
    radices = (ctypes.c_int * max(1, len(plan.radices)))(*plan.radices)
    perm = None if ordered else _device_perm(plan.n, str(device))
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *args,
            ctypes.addressof(radices),
            len(plan.radices),
            tabs.stage_flat.data_ptr(),
            tabs.split_tw.data_ptr(),
            None if perm is None else perm.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with cudaError {err}")
    kernel.launches += 1


def _require_cuda(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the Hopper kernels run on CUDA tensors, got {t.device}")


def rfft_packed_kernel(x: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """K1 on (rows, N) f32 -> ((rows, N/2), (rows, N/2)) f32."""
    if x.device.type == "cpu":
        return rfft_packed_plain(x, plan, ordered)
    _require_cuda(K1.name, x)
    rows = x.shape[0]
    _check("x", x, (rows, plan.n), x.device)
    yre = torch.empty((rows, plan.n // 2), dtype=torch.float32, device=x.device)
    yim = torch.empty_like(yre)
    if rows:
        _launch(K1, "k1_rfft_packed", plan, x.device, ordered,
                x.data_ptr(), yre.data_ptr(), yim.data_ptr(), rows, plan.n)
    return yre, yim


def irfft_packed_kernel(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan, ordered: bool = True):
    """K2 on packed planes (rows, N/2) x2 -> (rows, N) f32."""
    if yre.device.type == "cpu" and yim.device.type == "cpu":
        return irfft_packed_plain(yre, yim, plan, ordered)
    _require_cuda(K2.name, yre)
    rows = yre.shape[0]
    _check("yre", yre, (rows, plan.n // 2), yre.device)
    _check("yim", yim, (rows, plan.n // 2), yre.device)
    x = torch.empty((rows, plan.n), dtype=torch.float32, device=yre.device)
    if rows:
        _launch(K2, "k2_irfft_packed", plan, yre.device, ordered,
                yre.data_ptr(), yim.data_ptr(), x.data_ptr(), rows, plan.n)
    return x


def convolve_irfft_packed_kernel(are, aim, bre, bim, scale: float, plan: FFTPlan, ordered: bool = True):
    """K3: A (rows, N/2) x2, B (1 or rows, N/2) x2 -> irfft(scale * A (.) B)."""
    if all(t.device.type == "cpu" for t in (are, aim, bre, bim)):
        return convolve_irfft_packed_plain(are, aim, bre, bim, scale, plan, ordered)
    _require_cuda(K3.name, are)
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
        _launch(K3, "k3_convolve_irfft_packed", plan, are.device, ordered,
                are.data_ptr(), aim.data_ptr(), bre.data_ptr(), bim.data_ptr(),
                b_rows, float(scale), x.data_ptr(), rows, plan.n)
    return x


# ---------------------------------------------------------------------------
# Engine entry points (same signatures as the Stockham engine's)
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) -> contiguous, 8-byte aligned (rows, width) float32."""
    t = t.to(torch.float32).reshape(-1, width).contiguous()
    return t.clone() if t.data_ptr() % 8 else t


def _plan_for(n: int, plan: FFTPlan | None) -> FFTPlan:
    plan = plan or cached_plan(n, FFT_REAL)
    if plan.kind != FFT_REAL or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), real N={n}")
    return plan


def rfft_packed(x: torch.Tensor, plan: FFTPlan | None = None, ordered: bool = True):
    """Real FFT -> packed half-spectrum planes ((..., N/2) f32 x2)."""
    n = x.shape[-1]
    plan = _plan_for(n, plan)
    batch_shape = x.shape[:-1]
    yre, yim = rfft_packed_kernel(_rows(x, n), plan, ordered)
    return yre.reshape(*batch_shape, n // 2), yim.reshape(*batch_shape, n // 2)


def irfft_packed(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan | None = None, ordered: bool = True):
    """Unscaled inverse of :func:`rfft_packed` -> (..., N) f32."""
    m = yre.shape[-1]
    plan = _plan_for(2 * m, plan)
    batch_shape = yre.shape[:-1]
    x = irfft_packed_kernel(_rows(yre, m), _rows(yim, m), plan, ordered)
    return x.reshape(*batch_shape, 2 * m)


def convolve_irfft_packed(are, aim, bre, bim, plan: FFTPlan | None = None, scaling=1.0, ordered: bool = True):
    """Fused ``irfft_packed(A (.) B * scaling)``: the product spectrum
    never reaches device memory. A is (..., N/2) packed planes; B matches
    A's batch or is one shared spectrum (a filter). A tensor ``scaling``
    takes the unfused composition (same math)."""
    m = are.shape[-1]
    plan = _plan_for(2 * m, plan)
    if isinstance(scaling, torch.Tensor):
        pr, pi = convolve_accumulate_packed((are, aim), (bre, bim), scaling=scaling)
        return irfft_packed(pr, pi, plan, ordered)
    batch_shape = are.shape[:-1]
    af, aif = _rows(are, m), _rows(aim, m)
    bf, bif = _rows(bre, m), _rows(bim, m)
    if bf.shape[0] not in (1, af.shape[0]):
        raise ValueError(f"B batch {bf.shape[0]} must be 1 or match A batch {af.shape[0]}")
    x = convolve_irfft_packed_kernel(af, aif, bf, bif, float(scaling), plan, ordered)
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


_api.register_engine(
    "hopper",
    {
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
    prefers=prefer_plan,
)
