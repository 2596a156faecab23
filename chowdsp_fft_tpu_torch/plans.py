"""FFT plan construction: radix factorization + twiddle tables.

PyTorch counterpart of ``chowdsp_fft_tpu/plans.py``. A plan holds its
twiddle tables as float32 numpy arrays, cast once from float64 tables:
the native planner's (``utils/native.py``, long double with exact
argument reduction, the same tables as the JAX package's) where g++ can
build it, else numpy's. The same tables can be checked against the JAX
package and carried across (``convert.plan_from_numpy``,
:func:`save_plan`/:func:`load_plan` in the JAX package's ``.npz``
format). Device copies are made on first use per device and kept on the
plan; no plan owns a global device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal, Sequence

import numpy as np
import torch

from .utils import native

# Transform kinds.
FFT_REAL: str = "real"
FFT_COMPLEX: str = "complex"

# Directions.
FFT_FORWARD: str = "forward"
FFT_BACKWARD: str = "backward"

TransformKind = Literal["real", "complex"]


class InvalidSizeError(ValueError):
    """Raised when N cannot be handled."""


def factorize(n: int) -> tuple[int, ...]:
    """Factorize ``n`` into radices drawn from {2,3,4,5}.

    Greedy, the same order as the JAX package: radix-4 first, then one 2,
    then 3s, then 5s. Raises InvalidSizeError if a prime factor other than
    {2,3,5} remains.
    """
    if n < 2:
        raise InvalidSizeError(f"FFT size must be >= 2, got {n}")
    radices: list[int] = []
    m = n
    while m % 4 == 0:
        radices.append(4)
        m //= 4
    if m % 2 == 0:
        radices.append(2)
        m //= 2
    while m % 3 == 0:
        radices.append(3)
        m //= 3
    while m % 5 == 0:
        radices.append(5)
        m //= 5
    if m != 1:
        raise InvalidSizeError(
            f"FFT size {n} has prime factor(s) other than 2/3/5 (leftover {m})"
        )
    return tuple(radices)


def is_valid_size(n: int, kind: TransformKind = FFT_COMPLEX) -> bool:
    """True if ``n`` is supported for the given transform kind: {2,3,5}
    smooth, and even for real transforms."""
    try:
        factorize(n)
    except InvalidSizeError:
        return False
    if kind == FFT_REAL:
        return n % 2 == 0 and n >= 2
    return n >= 2


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One mixed-radix Stockham stage: the working array is viewed as
    (batch, r, m, s) with n = r*m the current sub-length and s the stride
    of earlier stages. ``tw_re/tw_im`` hold W_n^(j*p) = exp(-2i*pi*j*p/n)
    for j in [0, r), p in [0, m) (forward sign)."""

    radix: int
    m: int
    s: int
    tw_re: np.ndarray  # (radix, m) float32
    tw_im: np.ndarray  # (radix, m) float32


@dataclasses.dataclass(frozen=True, eq=False)
class FFTPlan:
    """Complete plan for a size-N transform.

    For kind == "real", the stages describe the half-length (N//2) complex
    transform of the half-complex algorithm, and ``rfft_tw_re/im`` hold the
    split twiddles exp(-2i*pi*k/N), k in [0, N/2).
    """

    n: int
    kind: str
    radices: tuple[int, ...]
    stages: tuple[StagePlan, ...]
    rfft_tw_re: np.ndarray | None
    rfft_tw_im: np.ndarray | None
    _on_device: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def device_tables(self, device: torch.device) -> "DeviceTables":
        """The plan's tables as complex64 tensors on ``device``, built on
        first use and kept for the plan's lifetime."""
        key = str(torch.device(device))
        tabs = self._on_device.get(key)
        if tabs is None:
            tabs = DeviceTables.build(self, device)
            self._on_device[key] = tabs
        return tabs


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Device copies of a plan's tables.

    ``stage_tw[i]`` is stage i's (radix, m) table; ``stage_flat`` is all of
    them flattened and concatenated in stage order (what the CUDA kernels
    read as float2); ``split_tw`` is the real plan's (N/2,) split table.
    complex64 storage is interleaved re/im, i.e. float2 on the card."""

    stage_tw: tuple[torch.Tensor, ...]
    stage_flat: torch.Tensor
    split_tw: torch.Tensor | None

    @staticmethod
    def build(plan: FFTPlan, device) -> "DeviceTables":
        def c64(re, im):
            return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)

        stage_tw = tuple(c64(st.tw_re, st.tw_im) for st in plan.stages)
        if stage_tw:
            flat = torch.cat([t.reshape(-1) for t in stage_tw])
        else:
            flat = torch.zeros(1, dtype=torch.complex64, device=device)
        split = None
        if plan.rfft_tw_re is not None:
            split = c64(plan.rfft_tw_re, plan.rfft_tw_im)
        return DeviceTables(stage_tw=stage_tw, stage_flat=flat, split_tw=split)


def _stage_twiddle_np(n: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Float64-computed twiddle table for one stage, cast to float32."""
    m = n // r
    j = np.arange(r, dtype=np.float64)[:, None]
    p = np.arange(m, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (j * p) / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _rfft_tw_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n // 2, dtype=np.float64)
    ang = -2.0 * np.pi * k / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _stage_tables(cn: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """float32 (re, im) tables of each stage of the length-cn Stockham
    plan: the native planner's where it is available, else numpy's."""
    tables = native.stage_twiddles(cn) if native.available() else None
    if tables is not None:
        return [(re.astype(np.float32), im.astype(np.float32)) for re, im in tables]
    out, sub = [], cn
    for r in factorize(cn):
        out.append(_stage_twiddle_np(sub, r))
        sub //= r
    return out


def _split_table(n: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 split twiddles of a real plan, as :func:`_stage_tables`."""
    tw = native.rfft_twiddles(n) if native.available() else None
    if tw is not None:
        return tw[0].astype(np.float32), tw[1].astype(np.float32)
    return _rfft_tw_np(n)


def _check_args(n: int, kind: str) -> None:
    if kind not in (FFT_REAL, FFT_COMPLEX):
        raise ValueError(f"unknown transform kind: {kind!r}")
    if not is_valid_size(n, kind):
        raise InvalidSizeError(f"unsupported FFT size {n} for kind={kind}")


def plan_with_tables(
    n: int,
    kind: TransformKind,
    stages: Sequence[tuple[np.ndarray, np.ndarray]],
    rfft_tw: tuple[np.ndarray, np.ndarray] | None = None,
) -> FFTPlan:
    """A plan holding the given tables as they are (cast to float32,
    nothing recomputed): ``stages`` is one (tw_re, tw_im) pair a stage in
    stage order, ``rfft_tw`` the split twiddles of a real plan. Shapes are
    checked against the factorization of N."""
    _check_args(n, kind)
    cn = n // 2 if kind == FFT_REAL else n
    radices: tuple[int, ...] = () if cn == 1 else factorize(cn)
    if len(stages) != len(radices):
        raise ValueError(f"expected {len(radices)} stage tables, got {len(stages)}")
    new_stages = []
    sub, s = cn, 1
    for r, (re, im) in zip(radices, stages):
        re = np.ascontiguousarray(re, dtype=np.float32)
        im = np.ascontiguousarray(im, dtype=np.float32)
        if re.shape != (r, sub // r) or im.shape != (r, sub // r):
            raise ValueError(f"stage table shape {re.shape} != expected {(r, sub // r)}")
        new_stages.append(StagePlan(radix=r, m=sub // r, s=s, tw_re=re, tw_im=im))
        sub, s = sub // r, s * r
    tw_re = tw_im = None
    if kind == FFT_REAL:
        if rfft_tw is None:
            raise ValueError("a real plan needs its split twiddles (rfft_tw)")
        tw_re = np.ascontiguousarray(rfft_tw[0], dtype=np.float32)
        tw_im = np.ascontiguousarray(rfft_tw[1], dtype=np.float32)
        if tw_re.shape != (n // 2,) or tw_im.shape != (n // 2,):
            raise ValueError(f"split twiddle shape {tw_re.shape} != expected {(n // 2,)}")
    return FFTPlan(
        n=n,
        kind=kind,
        radices=radices,
        stages=tuple(new_stages),
        rfft_tw_re=tw_re,
        rfft_tw_im=tw_im,
    )


def make_plan(n: int, kind: TransformKind = FFT_COMPLEX) -> FFTPlan:
    """Build a plan. Raises InvalidSizeError for unsupported N."""
    _check_args(n, kind)
    cn = n // 2 if kind == FFT_REAL else n
    stages = [] if cn == 1 else _stage_tables(cn)
    return plan_with_tables(n, kind, stages, _split_table(n) if kind == FFT_REAL else None)


@functools.lru_cache(maxsize=256)
def cached_plan(n: int, kind: TransformKind = FFT_COMPLEX) -> FFTPlan:
    """Memoized make_plan, used by the API when no plan is passed."""
    return make_plan(n, kind)


def _npz_path(path) -> str:
    # np.savez appends ".npz" to a name without it; load from the same file.
    path = str(path)
    return path if path.endswith(".npz") else f"{path}.npz"


def save_plan(plan: FFTPlan, path) -> None:
    """Write a plan to an ``.npz`` file in the JAX package's format: ``n``,
    ``kind`` and ``leaf0``..``leafK``, the tables in the JAX plan's pytree
    order (each stage's ``tw_re`` and ``tw_im`` in stage order, then
    ``rfft_tw_re`` and ``rfft_tw_im`` of a real plan). A plan saved by
    either package loads in the other."""
    leaves = [t for st in plan.stages for t in (st.tw_re, st.tw_im)]
    if plan.rfft_tw_re is not None:
        leaves += [plan.rfft_tw_re, plan.rfft_tw_im]
    np.savez(
        _npz_path(path),
        n=plan.n,
        kind=plan.kind,
        **{f"leaf{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
    )


def load_plan(path) -> FFTPlan:
    """Inverse of :func:`save_plan`: the tables come back bit-exactly, not
    recomputed, and no device copy is made before first use."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        n = int(z["n"])
        kind = str(z["kind"])
        _check_args(n, kind)
        cn = n // 2 if kind == FFT_REAL else n
        nstages = 0 if cn == 1 else len(factorize(cn))
        leaves = [z[f"leaf{i}"] for i in range(2 * nstages + (2 if kind == FFT_REAL else 0))]
    stages = list(zip(leaves[0 : 2 * nstages : 2], leaves[1 : 2 * nstages : 2]))
    return plan_with_tables(n, kind, stages, tuple(leaves[2 * nstages :]) if kind == FFT_REAL else None)
