"""Carry plans, filters and stream state from the JAX package to the port.

Plain functions: they take the JAX package's arrays as numpy (e.g.
``np.asarray(jax_array)``) and return the port's objects, so both packages
then compute the same thing on the same state. Unordered spectra keep
their layout where both sides use the same one (the four-step permutation
of ``ops.tables.unordered_perm`` on the JAX fused real kernel and on the
Hopper engine); where one side runs in natural order (a Stockham engine,
or a size outside the Hopper domain) they are reordered here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import api
from .ops.tables import LANES, inverse_perm, unordered_perm
from .plans import FFT_REAL, FFTPlan, InvalidSizeError, StagePlan, factorize, make_plan
from .stream.ols import PartitionedFIR

__all__ = [
    "plan_from_numpy",
    "partitioned_fir_from_numpy",
    "fir_state_from_numpy",
    "jax_unordered_is_permuted",
]

# Largest real N the JAX package's fused real kernel serves; above it, and
# at N <= 256, its packed "unordered" layout is the natural order.
_JAX_MAX_FUSED_REAL = 1 << 17


def jax_unordered_is_permuted(n: int, engine: str = "auto") -> bool:
    """Whether the JAX package's unordered packed layout for a real N under
    ``engine`` is the four-step permutation (else it is natural order)."""
    if engine == "stockham" or n % LANES or not 2 * LANES < n <= _JAX_MAX_FUSED_REAL:
        return False
    try:
        factorize(n // LANES)
    except InvalidSizeError:
        return False
    return True


def _port_unordered_is_permuted(n: int, engine: str) -> bool:
    name = api.engine_for(n, FFT_REAL) if engine == "auto" else engine
    return name == "hopper"


def _relayout(a: np.ndarray, n: int, src_permuted: bool, dst_permuted: bool) -> np.ndarray:
    if src_permuted == dst_permuted:
        return a
    return a[..., inverse_perm(n)] if src_permuted else a[..., unordered_perm(n)]


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
    template = make_plan(n, kind)
    if len(stages) != len(template.stages):
        raise ValueError(f"expected {len(template.stages)} stage tables, got {len(stages)}")
    new_stages = []
    for st, (re, im) in zip(template.stages, stages):
        re = np.ascontiguousarray(re, dtype=np.float32)
        im = np.ascontiguousarray(im, dtype=np.float32)
        if re.shape != st.tw_re.shape or im.shape != st.tw_im.shape:
            raise ValueError(f"stage table shape {re.shape} != expected {st.tw_re.shape}")
        new_stages.append(StagePlan(radix=st.radix, m=st.m, s=st.s, tw_re=re, tw_im=im))
    tw_re = tw_im = None
    if template.kind == FFT_REAL:
        if rfft_tw is None:
            raise ValueError("a real plan needs its split twiddles (rfft_tw)")
        tw_re = np.ascontiguousarray(rfft_tw[0], dtype=np.float32)
        tw_im = np.ascontiguousarray(rfft_tw[1], dtype=np.float32)
        if tw_re.shape != template.rfft_tw_re.shape or tw_im.shape != template.rfft_tw_im.shape:
            raise ValueError(f"split twiddle shape {tw_re.shape} != expected {template.rfft_tw_re.shape}")
    return FFTPlan(
        n=n,
        kind=template.kind,
        radices=template.radices,
        stages=tuple(new_stages),
        rfft_tw_re=tw_re,
        rfft_tw_im=tw_im,
    )


def partitioned_fir_from_numpy(
    h_re: np.ndarray,
    h_im: np.ndarray,
    block: int,
    engine: str = "auto",
    src_engine: str = "auto",
    device: torch.device | str = "cpu",
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
