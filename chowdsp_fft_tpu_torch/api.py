"""Public API: plans, complex and real transforms and convolution helpers
(PyTorch counterpart of ``chowdsp_fft_tpu/api.py``).

Semantics kept from the JAX package:

- transforms are unscaled in both directions: ifft(fft(x)) == N * x,
  irfft(rfft(x)) == N * x;
- complex transforms take and return complex64; the ``*_planes`` forms
  take and return SoA float32 (re, im) planes;
- packed planes are (..., N/2) float32 re/im with DC in re[0] and Nyquist
  in im[0];
- unordered transforms pair with the (packed) convolve for
  order-independent frequency-domain work. On the Hopper engine the
  unordered layouts are the JAX package's (``ops.tables.unordered_perm``
  for real N on K1-K3, ``ops.tables.cfft_unordered_perm`` for complex N
  on K4, natural order at the small-N sizes of K5); on the Stockham
  engine they are the natural order.

Results land on the input tensor's device. Engine dispatch:
``engine="auto"`` takes the Hopper engine for the sizes it serves and the
Stockham engine otherwise; an explicit engine that does not serve the
plan raises ValueError. On a CPU tensor the Hopper engine runs its
kernels' plain twins; on a CUDA tensor it launches the kernels.
"""

from __future__ import annotations

from typing import Callable

import torch

from .plans import (
    FFT_BACKWARD,
    FFT_COMPLEX,
    FFT_FORWARD,
    FFT_REAL,
    FFTPlan,
    InvalidSizeError,
    cached_plan,
    factorize,
    is_valid_size,
    make_plan,
)
from .ops import stockham
from .ops.convolve import (
    accumulate,
    convolve_accumulate,
    convolve_accumulate_packed,
    multiply_spectra,
)
from .ops.layout import packed_planes_to_spectrum, spectrum_to_packed_planes
from .utils.tracing import spanned

__all__ = [
    "FFT_FORWARD",
    "FFT_BACKWARD",
    "FFT_REAL",
    "FFT_COMPLEX",
    "FFTPlan",
    "InvalidSizeError",
    "make_plan",
    "cached_plan",
    "factorize",
    "is_valid_size",
    "available_engines",
    "engine_for",
    "engine_supports",
    "plan_bytes",
    "vector_width_bytes",
    "fft",
    "ifft",
    "fft_unordered",
    "ifft_unordered",
    "fft_planes",
    "ifft_planes",
    "fft_planes_unordered",
    "ifft_planes_unordered",
    "rfft",
    "irfft",
    "rfft_unordered",
    "irfft_unordered",
    "rfft_packed",
    "irfft_packed",
    "rfft_packed_unordered",
    "irfft_packed_unordered",
    "convolve_accumulate",
    "convolve_accumulate_packed",
    "convolve_irfft_packed",
    "multiply_spectra",
    "accumulate",
    "spectrum_to_packed_planes",
    "packed_planes_to_spectrum",
]

# ---------------------------------------------------------------------------
# Engine registry. The Hopper engine registers itself on import (see
# ops/hopper_fft.py); the Stockham engine is always available.
# ---------------------------------------------------------------------------

_ENGINES: dict[str, dict] = {}
_AUTO_ORDER = ("hopper", "stockham")


def register_engine(
    name: str,
    fns: dict[str, Callable],
    supports: Callable[[FFTPlan], bool],
    prefers: Callable[[FFTPlan], bool] | None = None,
):
    """``supports`` gates explicit ``engine=name`` requests; ``prefers``
    (default: ``supports``) gates what ``engine="auto"`` hands it."""
    _ENGINES[name] = {
        "fns": fns,
        "supports": supports,
        "prefers": supports if prefers is None else prefers,
    }


def _stockham_rfft_packed(x, plan=None):
    return spectrum_to_packed_planes(stockham.rfft(x, plan))


def _stockham_irfft_packed(re, im, plan=None):
    return stockham.irfft(packed_planes_to_spectrum(re, im), plan)


def _stockham_cfft_planes(re, im, plan=None, direction=FFT_FORWARD):
    z = stockham.cfft(torch.complex(re.to(torch.float32), im.to(torch.float32)), plan, direction)
    return z.real.contiguous(), z.imag.contiguous()


register_engine(
    "stockham",
    {
        "cfft": stockham.cfft,
        "rfft": stockham.rfft,
        "irfft": stockham.irfft,
        # Stockham output is naturally ordered; its "unordered" layout is
        # the ordered one.
        "cfft_unordered": stockham.cfft,
        "rfft_unordered": stockham.rfft,
        "irfft_unordered": stockham.irfft,
        "rfft_packed": _stockham_rfft_packed,
        "irfft_packed": _stockham_irfft_packed,
        "rfft_packed_unordered": _stockham_rfft_packed,
        "irfft_packed_unordered": _stockham_irfft_packed,
        "cfft_planes": _stockham_cfft_planes,
        "cfft_planes_unordered": _stockham_cfft_planes,
    },
    supports=lambda plan: True,
)


def _auto_name(plan: FFTPlan) -> str:
    for name in _AUTO_ORDER:
        e = _ENGINES.get(name)
        if e is not None and e["prefers"](plan):
            return name
    raise AssertionError("stockham engine should always be available")


def _pick_engine(plan: FFTPlan, engine: str) -> dict[str, Callable]:
    if engine == "auto":
        return _ENGINES[_auto_name(plan)]["fns"]
    e = _ENGINES.get(engine)
    if e is None:
        raise ValueError(f"unknown engine {engine!r}; have {sorted(_ENGINES)}")
    if not e["supports"](plan):
        raise ValueError(f"engine {engine!r} does not support plan (N={plan.n}, kind={plan.kind})")
    return e["fns"]


# ---------------------------------------------------------------------------
# Informational queries
# ---------------------------------------------------------------------------


def available_engines() -> tuple[str, ...]:
    """Registered engine names, fastest first."""
    names = [n for n in _AUTO_ORDER if n in _ENGINES]
    return tuple(names + [n for n in _ENGINES if n not in names])


def engine_for(n: int, kind: str = FFT_COMPLEX) -> str:
    """Which engine ``engine="auto"`` selects for this transform."""
    return _auto_name(cached_plan(n, kind))


def engine_supports(name: str, n: int, kind: str = FFT_COMPLEX) -> bool:
    """Whether an explicit ``engine=name`` request can serve this transform."""
    e = _ENGINES.get(name)
    if e is None:
        raise ValueError(f"unknown engine {name!r}; have {sorted(_ENGINES)}")
    return bool(e["supports"](cached_plan(n, kind)))


def plan_bytes(n: int, kind: str = FFT_COMPLEX) -> int:
    """Bytes of float32 twiddle tables a plan carries (the stage tables
    and a real plan's split table), the same count as the JAX package's:
    for capacity planning, the analog of the reference's
    ``fft_bytes_required``."""
    plan = cached_plan(n, kind)
    total = sum(st.tw_re.nbytes + st.tw_im.nbytes for st in plan.stages)
    if plan.rfft_tw_re is not None:
        total += plan.rfft_tw_re.nbytes + plan.rfft_tw_im.nbytes
    return total


def vector_width_bytes() -> int:
    """128: one warp's 32 float32 lanes, which is also the 128-byte
    transaction in which a warp's coalesced loads reach device memory.
    The Hopper analog of the JAX package's 512-byte VPU row (128 float32
    lanes) and of the reference's ``fft_simd_width_bytes`` (16 for
    SSE/NEON, 32 for AVX)."""
    return 32 * 4


# ---------------------------------------------------------------------------
# Transforms (unscaled: ifft(fft(x)) == N * x, irfft(rfft(x)) == N * x)
# ---------------------------------------------------------------------------


@spanned("api.fft")
def fft(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Ordered forward complex FFT over the last axis -> (..., N) complex64."""
    plan = plan or cached_plan(x.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft"](x, plan, FFT_FORWARD)


@spanned("api.ifft")
def ifft(spec: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Ordered backward complex FFT (unscaled: returns N * inverse)."""
    plan = plan or cached_plan(spec.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft"](spec, plan, FFT_BACKWARD)


@spanned("api.fft_unordered")
def fft_unordered(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Forward complex FFT in the engine's bin order (one fixed
    permutation per N, independent of the batch)."""
    plan = plan or cached_plan(x.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft_unordered"](x, plan, FFT_FORWARD)


@spanned("api.ifft_unordered")
def ifft_unordered(spec: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Backward complex FFT consuming the engine's bin order."""
    plan = plan or cached_plan(spec.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft_unordered"](spec, plan, FFT_BACKWARD)


@spanned("api.fft_planes")
def fft_planes(
    re: torch.Tensor,
    im: torch.Tensor,
    plan: FFTPlan | None = None,
    engine: str = "auto",
    direction: str = FFT_FORWARD,
):
    """Complex FFT on SoA float32 planes -> (re, im) planes (ordered),
    unscaled both directions."""
    plan = plan or cached_plan(re.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft_planes"](re, im, plan, direction)


@spanned("api.ifft_planes")
def ifft_planes(re: torch.Tensor, im: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"):
    return fft_planes(re, im, plan, engine, direction=FFT_BACKWARD)


@spanned("api.fft_planes_unordered")
def fft_planes_unordered(
    re: torch.Tensor,
    im: torch.Tensor,
    plan: FFTPlan | None = None,
    engine: str = "auto",
    direction: str = FFT_FORWARD,
):
    """Planes complex FFT in the engine's bin order."""
    plan = plan or cached_plan(re.shape[-1], FFT_COMPLEX)
    return _pick_engine(plan, engine)["cfft_planes_unordered"](re, im, plan, direction)


@spanned("api.ifft_planes_unordered")
def ifft_planes_unordered(re: torch.Tensor, im: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"):
    return fft_planes_unordered(re, im, plan, engine, direction=FFT_BACKWARD)


@spanned("api.rfft")
def rfft(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Real forward FFT -> canonical (..., N//2+1) complex64 spectrum."""
    plan = plan or cached_plan(x.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["rfft"](x, plan)


@spanned("api.irfft")
def irfft(spec: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Backward real FFT (unscaled): irfft(rfft(x)) == N * x -> (..., N) f32."""
    plan = plan or cached_plan(2 * (spec.shape[-1] - 1), FFT_REAL)
    return _pick_engine(plan, engine)["irfft"](spec, plan)


@spanned("api.rfft_unordered")
def rfft_unordered(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    """Canonical-type spectrum in the engine's bin order, Nyquist last."""
    plan = plan or cached_plan(x.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["rfft_unordered"](x, plan)


@spanned("api.irfft_unordered")
def irfft_unordered(spec: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto") -> torch.Tensor:
    plan = plan or cached_plan(2 * (spec.shape[-1] - 1), FFT_REAL)
    return _pick_engine(plan, engine)["irfft_unordered"](spec, plan)


@spanned("api.rfft_packed")
def rfft_packed(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"):
    """Real FFT -> packed half-spectrum planes ((..., N/2) f32 re, im):
    re[k]/im[k] hold bin k for k in [1, N/2); re[0] = DC, im[0] = Nyquist."""
    plan = plan or cached_plan(x.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["rfft_packed"](x, plan)


@spanned("api.irfft_packed")
def irfft_packed(
    re: torch.Tensor, im: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"
) -> torch.Tensor:
    """Unscaled inverse of :func:`rfft_packed`: (..., N) f32 == N * x."""
    plan = plan or cached_plan(2 * re.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["irfft_packed"](re, im, plan)


@spanned("api.rfft_packed_unordered")
def rfft_packed_unordered(x: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"):
    """Packed real FFT in the engine's bin order (bin 0 stays at index 0,
    so convolve_accumulate_packed applies unchanged)."""
    plan = plan or cached_plan(x.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["rfft_packed_unordered"](x, plan)


@spanned("api.irfft_packed_unordered")
def irfft_packed_unordered(
    re: torch.Tensor, im: torch.Tensor, plan: FFTPlan | None = None, engine: str = "auto"
) -> torch.Tensor:
    plan = plan or cached_plan(2 * re.shape[-1], FFT_REAL)
    return _pick_engine(plan, engine)["irfft_packed_unordered"](re, im, plan)


@spanned("api.convolve_irfft_packed")
def convolve_irfft_packed(
    are: torch.Tensor,
    aim: torch.Tensor,
    bre: torch.Tensor,
    bim: torch.Tensor,
    scaling: float | torch.Tensor = 1.0,
    plan: FFTPlan | None = None,
    engine: str = "auto",
    ordered: bool = True,
) -> torch.Tensor:
    """Fused spectral multiply + unscaled real inverse:
    ``irfft_packed(convolve_accumulate_packed(A, B, scaling=scaling))``, one
    kernel on the Hopper engine. B may be one shared spectrum (a filter)
    broadcast over A's batch. Engines without the fused kernel run the same
    unfused composition."""
    plan = plan or cached_plan(2 * are.shape[-1], FFT_REAL)
    eng = _pick_engine(plan, engine)
    fn = eng.get("convolve_irfft_packed")
    if fn is not None:
        return fn(are, aim, bre, bim, plan=plan, scaling=scaling, ordered=ordered)
    pr, pi = convolve_accumulate_packed((are, aim), (bre, bim), scaling=scaling)
    key = "irfft_packed" if ordered else "irfft_packed_unordered"
    return eng[key](pr, pi, plan)
