"""Carry plans, filters, stream state and models from the JAX package to
the port.

Plain functions: they take the JAX package's arrays as numpy (e.g.
``np.asarray(jax_array)``) and return the port's objects, so both packages
then compute the same thing on the same state. Unordered spectra keep
their layout where both sides use the same one (the four-step
permutations of ``ops.tables.unordered_perm`` for real N on the JAX fused
real kernel and on K1-K3, and of ``ops.tables.cfft_unordered_perm`` for
complex N on the JAX complex kernel and on K4); where one side runs in
natural order (a Stockham engine, the small-N transforms, or a size one
kernel serves and the other does not) they are reordered here. A complex
spectrum from the JAX two-level composite is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import api
from .models.convolver import ConvolverConfig, MultichannelConvolver
from .models.sdr import SDRChain, SDRChainConfig
from .ops import hopper_cfft, hopper_fft
from .ops.tables import (
    JAX_MAX_N,
    JAX_MAX_SMALL_FALLBACK,
    LANES,
    cfft_inverse_perm,
    cfft_unordered_perm,
    inverse_perm,
    is_smooth_multiple,
    jax_cfft_composite_is_natural,
    unordered_perm,
)
from .plans import FFT_COMPLEX, FFT_REAL, FFTPlan, plan_with_tables
from .stream.ols import PartitionedFIR

__all__ = [
    "plan_from_numpy",
    "partitioned_fir_from_numpy",
    "fir_state_from_numpy",
    "cfft_unordered_from_numpy",
    "sdr_chain_from_numpy",
    "convolver_from_numpy",
    "jax_unordered_is_permuted",
    "jax_cfft_is_composite",
]


def jax_unordered_is_permuted(n: int, engine: str = "auto") -> bool:
    """Whether the JAX package's unordered layout for N under ``engine`` is
    its kernels' four-step permutation, else natural order (above its
    single Stockham kernels, ``tables.JAX_MAX_N``, and at N <= 256). Holds
    for real N (the packed layout: the JAX real composite is always
    ordered) and for complex N outside :func:`jax_cfft_is_composite`."""
    return engine != "stockham" and 2 * LANES < n <= JAX_MAX_N and is_smooth_multiple(n)


def jax_cfft_is_composite(n: int, engine: str = "auto") -> bool:
    """Whether the JAX package runs complex N under ``engine`` as its
    two-level composite: above its single kernel, or a medium smooth size
    that is not a multiple of 128 (576, 960, ...) on an explicit
    ``engine="pallas"`` (``auto`` sends those to its Stockham engine). The
    composite's unordered layout depends on its factor split: natural
    order where both factors are multiples of 128 (v2,
    ``tables.jax_cfft_composite_is_natural``), else the digit-transposed
    sub-transform layouts of its v1 chain."""
    if engine == "stockham" or n <= JAX_MAX_SMALL_FALLBACK:
        return False
    if n <= JAX_MAX_N and is_smooth_multiple(n):
        return False
    return engine != "auto" or n % LANES == 0


def _port_engine(n: int, kind: str, engine: str) -> str:
    return api.engine_for(n, kind) if engine == "auto" else engine


def _port_unordered_is_permuted(n: int, engine: str) -> bool:
    """The port's real unordered layout is permuted only where K1-K3 serve
    N; at the K5 sizes the Hopper engine's layout is the natural order."""
    return _port_engine(n, FFT_REAL, engine) == "hopper" and hopper_fft._in_domain(n)


def _port_cfft_unordered_is_permuted(n: int, engine: str) -> bool:
    """The port's complex unordered layout is permuted only where K4 serves N."""
    return _port_engine(n, FFT_COMPLEX, engine) == "hopper" and hopper_cfft.in_domain(n)


def _relayout(a: np.ndarray, n: int, src_permuted: bool, dst_permuted: bool,
              perm=unordered_perm, inv=inverse_perm) -> np.ndarray:
    """Unordered (``perm(n)``) <-> natural order (``inv(n)`` undoes it)."""
    if src_permuted == dst_permuted:
        return a
    return a[..., inv(n)] if src_permuted else a[..., perm(n)]


def plan_from_numpy(
    n: int,
    kind: str,
    stages: Sequence[tuple[np.ndarray, np.ndarray]],
    rfft_tw: tuple[np.ndarray, np.ndarray] | None = None,
) -> FFTPlan:
    """A port plan holding the given tables: ``stages`` is the JAX plan's
    ``[(st.tw_re, st.tw_im) for st in plan.stages]`` and ``rfft_tw`` its
    ``(rfft_tw_re, rfft_tw_im)`` (real plans). Shapes are checked against
    the port's own factorization of N."""
    return plan_with_tables(n, kind, stages, rfft_tw)


def partitioned_fir_from_numpy(
    h_re: np.ndarray,
    h_im: np.ndarray,
    block: int,
    engine: str = "auto",
    src_engine: str = "auto",
    device: torch.device | str = "cuda",
) -> PartitionedFIR:
    """A port ``PartitionedFIR`` from the JAX filter's ``h_re``/``h_im``
    spectra ((..., P, block) f32, taken under JAX engine ``src_engine``)."""
    n = 2 * int(block)
    src = jax_unordered_is_permuted(n, src_engine)
    dst = _port_unordered_is_permuted(n, engine)
    re = _relayout(np.asarray(h_re, np.float32), n, src, dst)
    im = _relayout(np.asarray(h_im, np.float32), n, src, dst)
    return PartitionedFIR.from_spectra(
        torch.tensor(re, device=device),
        torch.tensor(im, device=device),
        block,
        engine,
    )


def fir_state_from_numpy(state: dict, fir: PartitionedFIR, src_engine: str = "auto") -> dict:
    """The port's state dict (``fdl_re``, ``fdl_im``, ``prev``) for ``fir``
    from a JAX ``PartitionedFIR`` state taken under ``src_engine``; tensors
    land on the filter's device."""
    src = jax_unordered_is_permuted(fir.n, src_engine)
    dst = _port_unordered_is_permuted(fir.n, fir.engine)
    dev = fir.h_re.device
    out = {}
    for key in ("fdl_re", "fdl_im", "prev"):
        a = np.asarray(state[key], np.float32)
        if key != "prev":
            a = _relayout(a, fir.n, src, dst)
        out[key] = torch.tensor(a, device=dev)
    return out


def cfft_unordered_from_numpy(
    spec: np.ndarray,
    src_engine: str = "auto",
    engine: str = "auto",
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """A JAX ``fft_unordered`` spectrum ((..., N) complex, taken under JAX
    engine ``src_engine``) as the port's ``fft_unordered`` layout under
    ``engine``, complex64 on ``device``. The JAX complex kernel permutes
    256 < N <= 2^17, the port's K4 only up to MAX_CN; between the two one
    side is natural and the other permuted. Where JAX ran N as its
    composite (:func:`jax_cfft_is_composite`), its v2 form is natural
    order and carried over; its v1 form's layout is not, and raises
    ValueError: take JAX's ordered ``fft`` spectrum there instead."""
    spec = np.asarray(spec, np.complex64)
    n = spec.shape[-1]
    composite = jax_cfft_is_composite(n, src_engine)
    if composite and not jax_cfft_composite_is_natural(n):
        raise ValueError(
            f"complex N={n} under JAX engine {src_engine!r} runs the v1 two-level composite, whose "
            "unordered layout is not carried over; convert the ordered spectrum (fft) instead"
        )
    src = not composite and jax_unordered_is_permuted(n, src_engine)
    dst = _port_cfft_unordered_is_permuted(n, engine)
    spec = _relayout(spec, n, src, dst, cfft_unordered_perm, cfft_inverse_perm)
    return torch.tensor(np.ascontiguousarray(spec), device=device)


def sdr_chain_from_numpy(
    config,
    front_lp: np.ndarray,
    audio_lp: np.ndarray,
    hpoly: np.ndarray,
    device: torch.device | str = "cuda",
) -> SDRChain:
    """A port ``SDRChain`` holding the JAX chain's filters (``chain.front_lp``,
    ``chain.audio_lp``, ``chain.channelizer.hpoly`` as numpy). ``config``
    is the port's ``SDRChainConfig`` or the JAX one (same fields)."""
    if not isinstance(config, SDRChainConfig):
        config = SDRChainConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(SDRChainConfig)})
    chain = SDRChain(config, device=device)
    for buf, value in ((chain.front_lp, front_lp), (chain.audio_lp, audio_lp),
                       (chain.channelizer.hpoly, hpoly)):
        value = np.asarray(value, np.float32)
        if value.shape != tuple(buf.shape):
            raise ValueError(f"filter shape {value.shape} != the config's {tuple(buf.shape)}")
        buf.copy_(torch.tensor(value))
    return chain


def convolver_from_numpy(
    jax_conv_h_re: np.ndarray,
    jax_conv_h_im: np.ndarray,
    config,
    src_engine: str = "auto",
    device: torch.device | str = "cuda",
) -> MultichannelConvolver:
    """A port ``MultichannelConvolver`` holding the JAX model's IR spectra
    (``conv.fir.h_re``/``h_im`` as numpy, (channels, P, block), taken under
    JAX engine ``src_engine``). ``config`` is the port's ``ConvolverConfig``
    or the JAX one (same fields). Streaming state crosses with
    :func:`fir_state_from_numpy` (``fir=conv.fir``)."""
    if not isinstance(config, ConvolverConfig):
        config = ConvolverConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(ConvolverConfig)})
    fir = partitioned_fir_from_numpy(jax_conv_h_re, jax_conv_h_im, config.block, engine=config.engine,
                                     src_engine=src_engine, device=device)
    return MultichannelConvolver.from_spectra(fir.h_re, fir.h_im, config)
