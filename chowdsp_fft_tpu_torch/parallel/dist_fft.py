"""Distributed FFT: one transform sharded across a mesh axis (counterpart
of ``chowdsp_fft_tpu/parallel/dist_fft.py``).

The four-step factorization N = A * C maps onto ranks holding the signal
time-contiguously (rows j of the row-major (A, C) view, n = j*C + k):

    X[q + A*t] = sum_k W_C^{±tk} * W_N^{±kq} * [ sum_j x[j*C+k] W_A^{±qj} ]

    step 1  all_to_all transpose: each rank gets C/D whole columns
    step 2  length-A FFTs along the now-local j axis     (the port's engine)
    step 3  twiddle W_N^{±kq}                          (local, a table slab)
    step 4  all_to_all transpose back
    step 5  length-C FFTs along the local k axis         (the port's engine)

Each all_to_all moves every element once (N/D a rank). The local FFTs are
the Hopper engine's entries (``ops/hopper_fft``): ``cfft_planes`` in its
unordered layout (K5, K4 or the composite) and, for the real transform,
``rfft_packed``/``irfft_packed`` (K5, K1/K2 or the composite), through
``ops/autodiff``'s Functions where an input requires grad. The
all_to_all is an autograd Function (:class:`_AllToAll`) whose backward
is the all_to_all of the gradient (its own adjoint for equal splits).

The result is in the transform's **distributed bin order**: the rank
owning output block f holds X[perm_A(f*A/D + q_loc) + A*perm_C(t)] at local
position q_loc*C + t, perm_L the port's own unordered layout of a
length-L complex FFT (:func:`_engine_perm`: K4's where K4 serves L,
natural order elsewhere). The JAX package folds its own kernel's layout
up to 2^17, so the two orders differ wherever a factor lies above K4's
13824; the split (A, C) is the same in both packages at every (N, D).
Frequency-domain elementwise work (convolution) is order-independent;
the inverses consume the order directly; :func:`spectrum_order` and
:func:`rspectrum_order` expose it.

Inputs are DTensors sharded along the last dim over ``axis_name``, or
tensors every rank holds whole (split in place, no traffic); outputs
are DTensors sharded the same way (``mesh.local_shard``, ``mesh.sharded``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ops import hopper_cfft, hopper_fft, tables
from ..plans import FFT_BACKWARD, FFT_COMPLEX, FFT_FORWARD, FFT_REAL, InvalidSizeError, cached_plan, factorize
from .mesh import TIME_AXIS, DeviceMesh, axis_group, local_shard, sharded

__all__ = [
    "sharded_fft_planes",
    "sharded_ifft_planes",
    "sharded_fft_convolve",
    "sharded_rfft_planes",
    "sharded_irfft_planes",
    "sharded_rfft_convolve",
    "spectrum_order",
    "rspectrum_order",
    "TRANSPOSES",
]

_MIN_FACTOR = 256  # smallest local row length of the JAX package's split


def _dist_ok_len(x: int) -> bool:
    """x is a local row length of the JAX package's split: {2,3,5}-smooth,
    within its single-kernel window (``JAX_MAX_N``), a multiple of 128 or
    inside its small direct-DFT domain. The JAX engine's limits, not the
    port's kernels': both packages shard the same sizes the same way (the
    port's engine serves every such length, above K4 on the composite)."""
    if x < _MIN_FACTOR or x > tables.JAX_MAX_N:
        return False
    if x % tables.LANES and x > tables.JAX_MAX_SMALL_FALLBACK:
        return False
    try:
        factorize(x)
    except InvalidSizeError:
        return False
    return True


@functools.lru_cache(maxsize=64)
def _dist_split(n: int, n_dev: int, real: bool = False) -> tuple[int, int]:
    """n = A * C, A >= C, both factors local row lengths (``_dist_ok_len``)
    divisible by n_dev; the most balanced such split. With ``real`` the
    level-1 factor A must be even: the local transforms are packed real
    FFTs of length A (A/2 planes, DC/Nyquist slot), which an odd A would
    silently corrupt."""
    err = ValueError(
        f"cannot shard N={n} over {n_dev} devices (need A*C with both "
        f"factors {{2,3,5}}-smooth, >= {_MIN_FACTOR}, <= {tables.JAX_MAX_N}, "
        f"divisible by {n_dev}{', A even for the real transform' if real else ''})"
    )
    if n <= 0:
        raise err
    m, pows = n, []
    for p in (2, 3, 5):
        e = 0
        while m % p == 0:
            m //= p
            e += 1
        pows.append(e)
    if m != 1:
        raise err
    best = None
    for e2 in range(pows[0] + 1):
        for e3 in range(pows[1] + 1):
            for e5 in range(pows[2] + 1):
                a = (2**e2) * (3**e3) * (5**e5)
                c = n // a
                if a < c or (real and a % 2) or a % n_dev or c % n_dev:
                    continue
                if not (_dist_ok_len(a) and _dist_ok_len(c)):
                    continue
                if best is None or a / c < best[0] / best[1]:
                    best = (a, c)
    if best is None:
        raise err
    return best


def _check_pipelineable(ndim: int, n_chunks: int) -> None:
    if n_chunks < 1:
        raise ValueError(f"pipeline_chunks must be >= 1, got {n_chunks}")
    if n_chunks > 1 and ndim < 2:
        raise ValueError(
            "pipeline_chunks > 1 requires a leading batch axis to split "
            "(a single unbatched transform is one strict dependency chain)"
        )


def _pipeline_chunks_call(fn, arrays, n_chunks: int):
    """Split the leading batch axis into ``n_chunks`` pieces and run the
    whole all_to_all -> local FFT -> all_to_all chain a piece (one piece:
    ``fn`` on the arrays as they are). The pieces share no data; here they
    run one after another (eager PyTorch has no scheduler to fly one
    piece's collective under another's FFTs), and the split keeps the JAX
    package's program shape."""
    if n_chunks == 1:
        return fn(*arrays)
    b = arrays[0].shape[0]
    edges = [round(i * b / n_chunks) for i in range(n_chunks + 1)]
    outs = [fn(*(a[s:e] for a in arrays)) for s, e in zip(edges, edges[1:]) if e > s]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


def _engine_perm(length: int) -> np.ndarray:
    """The port's unordered bin permutation of a length-``length`` complex
    FFT (``hopper_fft.cfft_planes(..., ordered=False)``): K4's digit layout
    (``tables.cfft_unordered_perm``) where K4 serves the length, natural
    order on K5 and the composite."""
    if hopper_cfft.in_domain(length):
        return tables.cfft_unordered_perm(length).astype(np.int64)
    return np.arange(length, dtype=np.int64)


@functools.lru_cache(maxsize=16)
def _dist_twiddle(n: int, a: int, forward: bool) -> tuple[np.ndarray, np.ndarray]:
    """(C, A) table W_N^(sgn * k * perm_A(q)), rows k: the level-1 FFTs run
    in the engine's unordered layout, whose permutation is folded into the
    columns here and into :func:`spectrum_order`."""
    c = n // a
    sgn = -1.0 if forward else 1.0
    k = np.arange(c, dtype=np.float64)[:, None]
    q = _engine_perm(a).astype(np.float64)[None, :]
    ang = sgn * 2.0 * np.pi * (k * q) / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def spectrum_order(n: int, n_dev: int, transform_chunks: int = 1) -> np.ndarray:
    """perm with perm[p] = the bin stored at flat position p of the
    distributed spectrum: p = q_row*C + t_col -> bin perm_A(q_row) +
    A*perm_C(t_col). ``transform_chunks`` must match the forward's (its
    chunked second transpose relabels the stored rows: ``_chunk_rowmap``)."""
    a, c = _dist_split(n, n_dev)
    pa = _engine_perm(a)
    pc = _engine_perm(c)
    p = np.arange(n, dtype=np.int64)
    rows = p // c
    if transform_chunks > 1:
        rows = _chunk_rowmap(a, n_dev, transform_chunks)[rows]
    return pa[rows] + a * pc[p % c]


class CallCount:
    """How many times a helper ran; the caller resets it."""

    def __init__(self) -> None:
        self.calls = 0


TRANSPOSES = CallCount()  # calls of _a2a_transpose: one all_to_all each


class _AllToAll(torch.autograd.Function):
    """all_to_all_single of a (D, ...) buffer into a fresh one (no output
    aliases its input, on one rank too); backward is the all_to_all of
    the gradient, its adjoint for equal splits."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """The differentiable all_to_all of a contiguous (D, ...) buffer: block
    d goes to the group's rank d; block i of the result came from rank i."""
    return _AllToAll.apply(send, group)


def _a2a_transpose(planes: tuple[torch.Tensor, ...], group, n_dev: int) -> tuple[torch.Tensor, ...]:
    """Distributed matrix transpose of every plane, one all_to_all for all.

    Local (..., rows_loc, cols) views of row-sharded global (R, cols)
    matrices -> local (..., cols/D, R) rows of the transposed matrices:
    the columns split into D contiguous groups, group d goes to rank d,
    and each rank transposes what it receives. Leading batch axes ride
    along. The send buffer is one copy of the planes (lazy views are
    resolved there), the receive buffer a fresh tensor."""
    TRANSPOSES.calls += 1
    *lead, r_loc, cols = planes[0].shape
    w = cols // n_dev
    send = torch.stack([p.resolve_conj().resolve_neg().reshape(*lead, r_loc, n_dev, w).movedim(-2, 0)
                        for p in planes], dim=1)  # (D, P, ..., rows_loc, w)
    recv = all_to_all(send, group)  # recv[i]: rank i's rows of this rank's column group
    nb = len(lead)
    order = (1, *range(2, 2 + nb), 3 + nb, 0, 2 + nb)  # (P, ..., w, D, rows_loc)
    out = recv.permute(order).reshape(len(planes), *lead, w, n_dev * r_loc)
    return tuple(out.unbind(0))


def _a2a_transpose_chunked(planes, group, n_dev: int, chunks: int):
    """Forward chunked transpose: the COLUMN axis in ``chunks`` contiguous
    slabs, one transpose a slab, the results concatenated along the row
    axis. Rank d's output row (g, t) then holds global column
    g*(cols/chunks) + d*(cols/(chunks*n_dev)) + t (folded into the spectrum
    order by ``_chunk_rowmap``); :func:`_a2a_transpose_chunked_rev` with the
    same ``chunks`` inverts it exactly."""
    if chunks == 1:
        return _a2a_transpose(planes, group, n_dev)
    cols = planes[0].shape[-1]
    if cols % (chunks * n_dev):
        raise ValueError(
            f"transform_chunks={chunks}: column count {cols} must divide by chunks*devices ({chunks * n_dev})"
        )
    w = cols // chunks
    outs = [_a2a_transpose(tuple(p[..., g * w : (g + 1) * w] for p in planes), group, n_dev) for g in range(chunks)]
    return tuple(torch.cat(parts, dim=-2) for parts in zip(*outs))


def _a2a_transpose_chunked_rev(planes, group, n_dev: int, chunks: int):
    """Inverse of :func:`_a2a_transpose_chunked`: the ROW axis in
    ``chunks`` slabs, one transpose a slab, concatenated along the column
    axis, which lands in natural column order."""
    if chunks == 1:
        return _a2a_transpose(planes, group, n_dev)
    rows = planes[0].shape[-2]
    if rows % chunks:
        raise ValueError(f"transform_chunks={chunks}: local row count {rows} must divide by chunks")
    w = rows // chunks
    outs = [_a2a_transpose(tuple(p[..., g * w : (g + 1) * w, :] for p in planes), group, n_dev)
            for g in range(chunks)]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def _chunk_rowmap(rows_total: int, n_dev: int, chunks: int) -> np.ndarray:
    """rowmap[stored_global_row] = semantic row under the chunked second
    transpose: stored row (d, g, t) holds semantic row
    g*(rows_total/chunks) + d*(rows_total/(chunks*n_dev)) + t."""
    i = np.arange(rows_total, dtype=np.int64)
    per_dev = rows_total // n_dev
    per_chunk_dev = per_dev // chunks
    d, rem = i // per_dev, i % per_dev
    g, t = rem // per_chunk_dev, rem % per_chunk_dev
    return g * (rows_total // chunks) + d * per_chunk_dev + t


@functools.lru_cache(maxsize=32)
def _table_slab(table_fn, n: int, a: int, args: tuple, device: str, index: int, n_dev: int):
    """This rank's rows of the (C, ...) tables ``table_fn(n, a, *args)`` on
    ``device`` (rows k of its column group after the first transpose)."""
    c = n // a
    lo, hi = index * (c // n_dev), (index + 1) * (c // n_dev)
    return tuple(torch.from_numpy(np.ascontiguousarray(t[lo:hi])).to(device) for t in table_fn(n, a, *args))


def _cfft(re, im, length: int, direction: str):
    """The engine's complex FFT of (..., length) planes, unordered layout."""
    return hopper_fft.cfft_planes(re, im, cached_plan(length, FFT_COMPLEX), direction, ordered=False)


class _Axis:
    """The mesh axis a transform is split over: its group, size, index."""

    def __init__(self, mesh: DeviceMesh, axis_name: str):
        self.mesh, self.name = mesh, axis_name
        self.group, self.size, self.index = axis_group(mesh, axis_name)

    def local(self, t) -> torch.Tensor:
        return local_shard(t, self.mesh, self.name, -1)

    def out(self, t: torch.Tensor):
        return sharded(t, self.mesh, self.name, -1)


def _fft_local(xr, xi, ax: _Axis, forward: bool, chunks: int):
    """Forward (or unscaled inverse, ``forward=False``) of the local shards
    (..., N/D) -> (..., N/D) in (out of) the distributed bin order."""
    d = ax.size
    n = xr.shape[-1] * d
    a, c = _dist_split(n, d)
    lead = xr.shape[:-1]
    twr, twi = _table_slab(_dist_twiddle, n, a, (forward,), str(xr.device), ax.index, d)
    if forward:
        g = _a2a_transpose((xr.reshape(*lead, a // d, c), xi.reshape(*lead, a // d, c)), ax.group, d)
        fr, fi = _cfft(*g, a, FFT_FORWARD)  # (..., C/D, A), unordered
        fr, fi = fr * twr - fi * twi, fr * twi + fi * twr
        h = _a2a_transpose_chunked((fr, fi), ax.group, d, chunks)  # (..., A/D, C)
        yr, yi = _cfft(*h, c, FFT_FORWARD)
    else:
        h = _cfft(xr.reshape(*lead, a // d, c), xi.reshape(*lead, a // d, c), c, FFT_BACKWARD)
        fr, fi = _a2a_transpose_chunked_rev(h, ax.group, d, chunks)  # (..., C/D, A)
        fr, fi = fr * twr - fi * twi, fr * twi + fi * twr
        g = _cfft(fr, fi, a, FFT_BACKWARD)
        yr, yi = _a2a_transpose(g, ax.group, d)  # (..., A/D, C), time order
    return yr.reshape(*lead, -1), yi.reshape(*lead, -1)


def _complex_entry(re, im, mesh, axis_name, pipeline_chunks, transform_chunks, forward: bool):
    ax = _Axis(mesh, axis_name)
    xr = ax.local(re).to(torch.float32)
    xi = ax.local(im).to(torch.float32)
    _check_pipelineable(xr.ndim, pipeline_chunks)
    yr, yi = _pipeline_chunks_call(lambda r, i: _fft_local(r, i, ax, forward, transform_chunks), [xr, xi],
                                   pipeline_chunks)
    return ax.out(yr), ax.out(yi)


def sharded_fft_planes(re, im, mesh: DeviceMesh, axis_name: str = TIME_AXIS, pipeline_chunks: int = 1,
                       transform_chunks: int = 1):
    """Forward complex FFTs of length N distributed over the mesh axis,
    batched, unscaled. ``re``/``im``: (..., N) float32 planes, the last
    dim sharded over ``axis_name`` (DTensors, or tensors every rank holds
    whole). Returns (..., N) DTensor planes in the distributed bin order
    (:func:`spectrum_order`), sharded the same way. ``pipeline_chunks`` > 1
    splits the leading batch axis into that many independent chains;
    ``transform_chunks`` > 1 slabs the SECOND all_to_all (unbatched too)
    and changes the stored order: pass the same value to
    :func:`spectrum_order` and :func:`sharded_ifft_planes`."""
    return _complex_entry(re, im, mesh, axis_name, pipeline_chunks, transform_chunks, True)


def sharded_ifft_planes(re, im, mesh: DeviceMesh, axis_name: str = TIME_AXIS, pipeline_chunks: int = 1,
                        transform_chunks: int = 1):
    """Unscaled inverse consuming the distributed bin order of
    :func:`sharded_fft_planes` (``transform_chunks`` must match its);
    returns time-ordered (..., N) DTensor planes (ifft(fft(x)) == N * x)."""
    return _complex_entry(re, im, mesh, axis_name, pipeline_chunks, transform_chunks, False)


# ---------------------------------------------------------------------------
# The distributed REAL transform. Level 1 runs the local packed rfft of
# length A; only the A/2+1 Hermitian-independent rows travel through the
# second all_to_all.
#
# Distributed packed real spectrum: planes (..., rows_p * C) sharded over
# the axis, viewed as (rows_p, C) with rows_p = A/2+1 zero-padded up to a
# multiple of D (times the transform-chunk count). Row r <= A/2 at column
# t holds X[r + A*perm_C(t)] of the FULL length-N spectrum (rows 0 and A/2
# carry their whole Hermitian-redundant line; padding rows are zero). DC
# is (0, 0); the global Nyquist X[N/2] sits in row A/2 where perm_C(t) =
# C/2. Elementwise products need no DC/Nyquist patch-up, which
# sharded_rfft_convolve relies on.
# ---------------------------------------------------------------------------


def _rdist_rows(a: int, n_dev: int, chunks: int = 1) -> int:
    """A/2+1 spectral rows padded up to a multiple of n_dev * chunks."""
    r = a // 2 + 1
    q = n_dev * chunks
    return -(-r // q) * q


@functools.lru_cache(maxsize=16)
def _rdist_tables(n: int, a: int):
    """(C, A/2-1) level-2 twiddles W_N^{-k1 c} for k1 in [1, A/2) and the
    (C, 1) Nyquist half-bin modulation W_2C^{-c} (float64 -> float32)."""
    c = n // a
    cc = np.arange(c, dtype=np.float64)[:, None]
    k1 = np.arange(1, a // 2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (cc * k1) / float(n)
    ang_ny = -np.pi * cc / float(c)
    return (
        np.cos(ang).astype(np.float32),
        np.sin(ang).astype(np.float32),
        np.cos(ang_ny).astype(np.float32),
        np.sin(ang_ny).astype(np.float32),
    )


def rspectrum_order(n: int, n_dev: int, transform_chunks: int = 1) -> np.ndarray:
    """perm[p] = index into the FULL length-N spectrum of the bin stored at
    flat position p of the distributed packed real spectrum (-1 for the
    zero padding rows). Rows 0 and A/2 hold their whole Hermitian line, so
    values > N/2 appear there."""
    a, c = _dist_split(n, n_dev, real=True)
    rows_p = _rdist_rows(a, n_dev, transform_chunks)
    pc = _engine_perm(c)
    out = np.full(rows_p * c, -1, dtype=np.int64)
    rowmap = (_chunk_rowmap(rows_p, n_dev, transform_chunks) if transform_chunks > 1
              else np.arange(rows_p, dtype=np.int64))
    for stored in range(rows_p):
        r = rowmap[stored]
        if r <= a // 2:
            out[stored * c : (stored + 1) * c] = r + a * pc
    return out


def _rfft_local(x, ax: _Axis, chunks: int):
    """Local shard (..., N/D) real -> distributed packed planes (..., rows_p*C/D)."""
    d = ax.size
    n = x.shape[-1] * d
    a, c = _dist_split(n, d, real=True)
    half_a = a // 2
    rows_p = _rdist_rows(a, d, chunks)
    twr, twi, nytr, nyti = _table_slab(_rdist_tables, n, a, (), str(x.device), ax.index, d)
    lead = x.shape[:-1]
    (g,) = _a2a_transpose((x.reshape(*lead, a // d, c),), ax.group, d)  # (..., C/D, A) real
    pre, pim = hopper_fft.rfft_packed(g, cached_plan(a, FFT_REAL), ordered=True)
    # Level-2 rows per column: DC (real), twiddled k1 = 1..A/2-1, and the
    # Nyquist (slot 0's im) pre-modulated by W_2C^{-c}, whose half-bin
    # shifted transform becomes a plain C-point FFT; zero padding rows.
    dc, ny = pre[..., :1], pim[..., :1]
    mid_re = pre[..., 1:] * twr - pim[..., 1:] * twi
    mid_im = pre[..., 1:] * twi + pim[..., 1:] * twr
    z = dc.new_zeros((*dc.shape[:-1], rows_p - (half_a + 1)))
    lvl_re = torch.cat([dc, mid_re, ny * nytr, z], dim=-1)
    lvl_im = torch.cat([torch.zeros_like(dc), mid_im, ny * nyti, z], dim=-1)
    h = _a2a_transpose_chunked((lvl_re, lvl_im), ax.group, d, chunks)  # (..., rows_p/D, C)
    yr, yi = _cfft(*h, c, FFT_FORWARD)
    return yr.reshape(*lead, -1), yi.reshape(*lead, -1)


def _irfft_local(re, im, n: int, ax: _Axis, chunks: int):
    """Distributed packed planes (..., rows_p*C/D) -> local real shard (..., N/D), unscaled."""
    d = ax.size
    a, c = _dist_split(n, d, real=True)
    half_a = a // 2
    rows_p = _rdist_rows(a, d, chunks)
    if re.shape[-1] * d != rows_p * c:
        raise ValueError(f"planes of {re.shape[-1] * d} slots are not the packed spectrum of N={n} over {d} "
                         f"devices ({rows_p * c})")
    twr, twi, nytr, nyti = _table_slab(_rdist_tables, n, a, (), str(re.device), ax.index, d)
    lead = re.shape[:-1]
    h = _cfft(re.reshape(*lead, rows_p // d, c), im.reshape(*lead, rows_p // d, c), c, FFT_BACKWARD)
    ur, ui = _a2a_transpose_chunked_rev(h, ax.group, d, chunks)  # (..., C/D, rows_p), natural rows
    ur, ui = ur[..., : half_a + 1], ui[..., : half_a + 1]
    # Un-twiddle and rebuild the local packed level-1 planes (the backward
    # C-FFT carries a factor C; the DC/Nyquist rows' imaginary parts cancel).
    mid_re = ur[..., 1:half_a] * twr + ui[..., 1:half_a] * twi
    mid_im = -ur[..., 1:half_a] * twi + ui[..., 1:half_a] * twr
    ny = ur[..., half_a:] * nytr + ui[..., half_a:] * nyti
    pre = torch.cat([ur[..., :1], mid_re], dim=-1)
    pim = torch.cat([ny, mid_im], dim=-1)
    g = hopper_fft.irfft_packed(pre, pim, cached_plan(a, FFT_REAL), ordered=True)  # (..., C/D, A)
    (x,) = _a2a_transpose((g,), ax.group, d)  # (..., A/D, C), time order
    return x.reshape(*lead, -1)


def sharded_rfft_planes(x, mesh: DeviceMesh, axis_name: str = TIME_AXIS, pipeline_chunks: int = 1,
                        transform_chunks: int = 1):
    """Distributed real forward FFT, batched, unscaled: (..., N) real with
    the last dim sharded over ``axis_name`` -> distributed packed real
    spectrum DTensor planes (..., rows_p * C), sharded the same way.
    ``pipeline_chunks``/``transform_chunks``: see
    :func:`sharded_fft_planes` (the chunked order is
    ``rspectrum_order(n, n_dev, transform_chunks)``)."""
    ax = _Axis(mesh, axis_name)
    xl = ax.local(x).to(torch.float32)
    _check_pipelineable(xl.ndim, pipeline_chunks)
    yr, yi = _pipeline_chunks_call(lambda v: _rfft_local(v, ax, transform_chunks), [xl], pipeline_chunks)
    return ax.out(yr), ax.out(yi)


def sharded_irfft_planes(re, im, mesh: DeviceMesh, n: int, axis_name: str = TIME_AXIS, pipeline_chunks: int = 1,
                         transform_chunks: int = 1):
    """Unscaled inverse of :func:`sharded_rfft_planes` (irfft(rfft(x)) ==
    N * x): distributed packed planes -> the time-sharded (..., N) real
    DTensor. ``n`` is the signal length (the padded planes do not fix it);
    ``transform_chunks`` must match the forward's."""
    ax = _Axis(mesh, axis_name)
    yr = ax.local(re).to(torch.float32)
    yi = ax.local(im).to(torch.float32)
    _check_pipelineable(yr.ndim, pipeline_chunks)
    return ax.out(_pipeline_chunks_call(lambda r, i: _irfft_local(r, i, n, ax, transform_chunks), [yr, yi],
                                        pipeline_chunks))


def _chunks_for(t: torch.Tensor, pipeline_chunks: int) -> int:
    """A filter without a batch axis runs as one chain."""
    return pipeline_chunks if t.ndim > 1 else 1


def _product(ar, ai, br, bi, s):
    """(A * B) * s on (re, im) planes."""
    return (ar * br - ai * bi) * s, (ar * bi + ai * br) * s


def sharded_rfft_convolve(x, h, mesh: DeviceMesh, axis_name: str = TIME_AXIS, scaling=None,
                          pipeline_chunks: int = 1, transform_chunks: int = 1):
    """Circular convolution of real length-N signals, distributed and
    batched: two distributed real forwards, the elementwise product on the
    distributed packed layout, one distributed real inverse. ``h`` is
    sharded like ``x`` (a length-N signal, batched or not). ``scaling``
    defaults to 1/N. Returns the time-sharded DTensor."""
    ax = _Axis(mesh, axis_name)
    xl, hl = ax.local(x).to(torch.float32), ax.local(h).to(torch.float32)
    n = xl.shape[-1] * ax.size
    s = (1.0 / n) if scaling is None else scaling
    _check_pipelineable(xl.ndim, pipeline_chunks)
    forward = lambda v: _rfft_local(v, ax, transform_chunks)  # noqa: E731
    pr, pi = _product(*_pipeline_chunks_call(forward, [xl], pipeline_chunks),
                      *_pipeline_chunks_call(forward, [hl], _chunks_for(hl, pipeline_chunks)), s)
    inverse = lambda r, i: _irfft_local(r, i, n, ax, transform_chunks)  # noqa: E731
    return ax.out(_pipeline_chunks_call(inverse, [pr, pi], pipeline_chunks))


def sharded_fft_convolve(x_re, x_im, h_re, h_im, mesh: DeviceMesh, axis_name: str = TIME_AXIS, scaling=None,
                         pipeline_chunks: int = 1, transform_chunks: int = 1):
    """Circular convolution of two length-N complex signals, everything
    distributed: two sharded forward FFTs, the elementwise product (the
    distributed bin order never matters), one sharded inverse. ``scaling``
    defaults to 1/N. Returns the time-sharded (re, im) DTensors."""
    ax = _Axis(mesh, axis_name)
    xr, xi, hr, hi = (ax.local(t).to(torch.float32) for t in (x_re, x_im, h_re, h_im))
    n = xr.shape[-1] * ax.size
    s = (1.0 / n) if scaling is None else scaling
    _check_pipelineable(xr.ndim, pipeline_chunks)
    forward = lambda u, v: _fft_local(u, v, ax, True, transform_chunks)  # noqa: E731
    pr, pi = _product(*_pipeline_chunks_call(forward, [xr, xi], pipeline_chunks),
                      *_pipeline_chunks_call(forward, [hr, hi], _chunks_for(hr, pipeline_chunks)), s)
    inverse = lambda u, v: _fft_local(u, v, ax, False, transform_chunks)  # noqa: E731
    yr, yi = _pipeline_chunks_call(inverse, [pr, pi], pipeline_chunks)
    return ax.out(yr), ax.out(yi)
