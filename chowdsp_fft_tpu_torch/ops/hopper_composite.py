"""K6, K7a, K7b: the two-level composite FFT on hand-written CUDA kernels
(``csrc/composite_fft.cu``), counterpart of ``chowdsp_fft_tpu/ops/pallas_fft.py``
:2392-2850 (the complex composite v2) and :3099-3353 (the real one).

N = A * C (``tables.split_large``). Viewing a row as (A, C), the forward
complex transform is

- level 1 (K6 ``l1``): length-A FFTs down the C columns of the (B, A, C)
  input, stored transposed as (B, C, A);
- level 2 (K6 ``l2``): the four-step twiddle W_N^(-c*k1) (``tables.large_twiddle``),
  then length-C FFTs down the A columns of (B, C, A), stored in place.

The (B, C, A) output is the natural-order spectrum (bin k1 + A*k2 at flat
position k2*A + k1). The backward transform mirrors it: ``l2_rev`` (inverse
length-C FFTs, then the conjugate twiddle) and ``l1_rev`` (inverse length-A
FFTs of the rows, stored transposed as (B, A, C)). One CUDA kernel serves
the four roles; the intermediate is one device buffer (or one pair of
planes) that the wrapper allocates.

The real composite (N = A * C, both even) is K7a, a column-blocked packed
real FFT of length A from (B, A, C) to (B, C, A/2) planes with DC in
re[..., 0] and the level-1 Nyquist in im[..., 0]; the DC and Nyquist
lines as two length-C complex transforms (K5, K4 or this composite,
through :func:`cfft_rows`); then K6 ``l2`` on the planes with
``tables.rdc_l2_twiddle``, whose store is the Hermitian assembly: it
writes the ordered packed planes (B, C/2, A) by :func:`packed_index`'s
map, grid column 0 from the lines (:func:`level2_packed`). The inverse
mirrors it: K6 ``l2_rev`` gathers the grid from the packed planes and a
column 0 built from the lines (:func:`level2_rev_packed`), then K7b. The
plain versions of the two packed forms are the JAX package's assembly in
torch (``cat``s and ``flip``s, as it has it in XLA).

Each composite (:func:`cfft_composite`, :func:`rfft_composite`,
:func:`irfft_composite`) runs in a span ``ops.hopper_composite.<name>``
(``utils/tracing.py``): its kernels' launches keep their own launch
spans, so the device ops innermost in a composite's span are its torch
glue: on the card, the ops on the (B, C) DC and Nyquist lines.

Layout: natural order in and out at every batch, so at composite sizes
the engine's unordered layout is the ordered one (the JAX v2 composite's
choice, ``_cfft_pair_large`` :2834).

Each kernel has a plain version here: the same four-step in plain torch
on the same split and tables, the sub-FFTs on the Stockham engine. A
wrapper runs the plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises.

Not ported, as TPU VMEM artefacts with no counterpart here: the batch
chunking (``_batch_chunked`` :3142, ``_v2_batch_cap``), the VMEM tile laws
(``_v2_tile``, ``_col_tile``, ``_V2_BLOCK_BYTES``) and the v1 chains
(``_cfft_pair_large_v1`` :2851, ``_rfft/_irfft_direct_composite_v1``
:3356, :3414). K6, K7a and K7b run the column engine
(``csrc/col_passes.cuh``), whose tile, pass plan and grid come from
``col_passes.launch_geometry``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..plans import FFT_COMPLEX, FFT_REAL, FFTPlan, cached_plan
from ..utils.tracing import spanned
from . import col_passes, hopper_cfft, hopper_small, stockham
from ._cuda import MAX_COL, MAX_N, Kernel, check, host_ints, launch, require_domain, takes_plain
from .hopper_cfft import as_complex, complex_io, like, shape_of
from .layout import packed_planes_to_spectrum, spectrum_to_packed_planes
from .tables import (
    JAX_MAX_COMPOSITE,
    JAX_MIN_SMALL,
    LANES,
    is_smooth_multiple,
    jax_has_composite_split,
    large_twiddle,
    nyquist_twiddle,
    rdc_l2_twiddle,
    split_large,
)

__all__ = [
    "K6_L1",
    "K6_L2",
    "K6_L2_REV",
    "K6_L1_REV",
    "K7A",
    "K7B",
    "KERNELS",
    "MAX_COL",
    "level1",
    "level2",
    "rfft_cols",
    "irfft_cols",
    "level2_packed",
    "level2_rev_packed",
    "level1_plain",
    "level2_plain",
    "level2_packed_plain",
    "level2_rev_packed_plain",
    "hermitian_assembly",
    "hermitian_grid",
    "packed_index",
    "rfft_cols_plain",
    "irfft_cols_plain",
    "cfft_composite",
    "rfft_composite",
    "irfft_composite",
    "cfft_rows",
    "column_lengths",
    "real_splits",
    "in_place_role",
]

_SRC = "chowdsp_fft_tpu_torch/csrc/composite_fft.cu"
_JAX = "chowdsp_fft_tpu/ops/pallas_fft.py"
K6_L1 = Kernel("composite_l1_kernel", _SRC, f"{_JAX}:2700 (_v2_call, body _cfft_v2_l1_kernel :2531)")
K6_L2 = Kernel("composite_l2_kernel", _SRC, f"{_JAX}:2700 (_v2_call, body _cfft_v2_l2_kernel :2556)")
K6_L2_REV = Kernel("composite_l2_rev_kernel", _SRC, f"{_JAX}:2700 (_v2_call, body _cfft_v2_l2_rev_kernel :2587)")
K6_L1_REV = Kernel("composite_l1_rev_kernel", _SRC, f"{_JAX}:2700 (_v2_call, body _cfft_v2_l1_rev_kernel :2621)")
K7A = Kernel("rfft_cols_kernel", _SRC, f"{_JAX}:1463 (_rfft_packed_cols_impl, body _rfft_cols_kernel :1398)")
K7B = Kernel("irfft_cols_kernel", _SRC, f"{_JAX}:1565 (_irfft_packed_cols_impl, body _irfft_cols_kernel :1541)")
KERNELS = (K6_L1, K6_L2, K6_L2_REV, K6_L1_REV, K7A, K7B)


def _col_ok(length: int) -> bool:
    return JAX_MIN_SMALL <= length <= MAX_COL


@functools.lru_cache(maxsize=1)
def _composite_splits() -> tuple[frozenset, frozenset]:
    """The complex and the real splits (A, C) of every size this engine
    sends to the composite (up to 2^20)."""
    smooth = sorted(p2 * p3 * p5 for p2 in (2 ** i for i in range(21)) for p3 in (3 ** i for i in range(13))
                    for p5 in (5 ** i for i in range(9)) if JAX_MIN_SMALL <= p2 * p3 * p5 <= JAX_MAX_COMPOSITE)
    complex_splits, real = set(), set()
    for n in smooth:
        if hopper_small.in_domain(n):
            continue
        if not hopper_cfft.in_domain(n) and jax_has_composite_split(n):
            complex_splits.add(split_large(n))
        k1 = 2 * LANES < n <= MAX_N and is_smooth_multiple(n)
        if n % 2 == 0 and not k1 and jax_has_composite_split(n, real=True):
            real.add(split_large(n, real=True))
    return frozenset(complex_splits), frozenset(real)


def real_splits() -> tuple[tuple[int, int], ...]:
    """Every split (A, C) the real composite runs."""
    return tuple(sorted(_composite_splits()[1]))


@functools.lru_cache(maxsize=1)
def column_lengths() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Every column length the composite's kernels run, over every size
    this engine sends to the composite (up to 2^20): K6's complex lengths
    (both factors of a complex split and C of a real one) and K7's real
    lengths A."""
    complex_splits, real = _composite_splits()
    complex_lengths = {n for split in complex_splits for n in split} | {c for _, c in real}
    return tuple(sorted(complex_lengths)), tuple(sorted({a for a, _ in real}))


# ---------------------------------------------------------------------------
# Tables on the device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _c64(table, n: int, forward: bool, device: str) -> torch.Tensor:
    re, im = table(n, forward)
    return torch.complex(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())).to(device)


@functools.lru_cache(maxsize=32)
def _nyquist(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(t.copy()).to(device) for t in nyquist_twiddle(n))


def twiddle(n: int, forward: bool, device) -> torch.Tensor:
    """(C, A) complex64 four-step twiddle of the complex composite."""
    return _c64(large_twiddle, n, forward, str(torch.device(device)))


def real_twiddle(n: int, forward: bool, device) -> torch.Tensor:
    """(C, A/2) complex64 level-2 twiddle of the real composite."""
    return _c64(rdc_l2_twiddle, n, forward, str(torch.device(device)))


# ---------------------------------------------------------------------------
# Complex data in either form: one complex64 tensor or a (re, im) pair
# ---------------------------------------------------------------------------


def _view(x, shape):
    return x.reshape(shape) if isinstance(x, torch.Tensor) else tuple(t.reshape(shape) for t in x)


def _launch_columns(kernel: Kernel, entry: str, dev, plan: FFTPlan, batch: int, cols: int, segment_bytes: int,
                    in_place: bool, args, table):
    """Launch a column-engine entry (K6, K7a, K7b) with ``args``, then the
    plan's radices, the pass plan and its twiddles, ``table`` (the
    four-step or the split twiddles) and the launch geometry over ``batch``
    rows of ``cols`` columns of ``segment_bytes`` a row and plane, in place
    where ``in_place`` and the plan allow (``col_passes.launch_geometry``)."""
    g = col_passes.launch_geometry(plan, batch, cols, segment_bytes, in_place)
    pass_tw = col_passes.device_twiddles(plan.n, plan.kind, plan.radices, str(dev))
    launch(kernel, entry, dev, *args, ctypes.addressof(host_ints(plan.radices)), len(plan.radices),
           ctypes.addressof(host_ints(g.flat_passes)), len(g.passes), pass_tw.data_ptr(), table, *g.args)


# ---------------------------------------------------------------------------
# K6: the column FFT in its four roles
# ---------------------------------------------------------------------------


def in_place_role(kernel: Kernel, stride: int) -> bool:
    """Whether a column-engine kernel takes in-place tiles where its plan
    allows (one buffer, twice the columns, two blocks an SM) or narrow
    two-buffer tiles (three blocks an SM). Measured on the H100 at
    N = 2^20 (PERF.md §6): in place is faster for K6 l1 and l2 in both
    forms, for l2_rev on complex64 and for K7a (0.244 against 0.346 ms:
    like l1, it reads columns and writes rows); two buffers for l1_rev
    and K7b (whose inputs are rows) and for l2_rev on planes."""
    return kernel is K6_L1 or kernel is K6_L2 or kernel is K7A or (kernel is K6_L2_REV and stride == 2)


def level1_plain(x, plan: FFTPlan, forward: bool = True):
    """Plain version of K6 level 1. Forward: (B, A, C) -> length-A FFTs of
    the columns -> (B, C, A). Backward: (B, C, A) -> inverse length-A FFTs
    of the rows -> (B, A, C)."""
    z = as_complex(x)
    b, d1, d2 = z.shape
    if forward:
        rows = z.transpose(1, 2).reshape(b * d2, d1)
        return like(x, stockham.cfft(rows, plan, "forward").reshape(b, d2, d1))
    y = stockham.cfft(z.reshape(b * d1, d2), plan, "backward").reshape(b, d1, d2)
    return like(x, y.transpose(1, 2).contiguous())


def level2_plain(x, tw: torch.Tensor, plan: FFTPlan, forward: bool = True):
    """Plain version of K6 level 2 on (B, C, M): forward multiplies by the
    (C, M) twiddle, then length-C FFTs down the columns; backward runs the
    inverse FFTs, then multiplies by the (conjugate-angle) twiddle."""
    z = as_complex(x)
    b, c, m = z.shape
    if forward:
        z = z * tw
    rows = z.transpose(1, 2).reshape(b * m, c)
    y = stockham.cfft(rows, plan, "forward" if forward else "backward")
    y = y.reshape(b, m, c).transpose(1, 2)
    if not forward:
        y = y * tw
    return like(x, y.contiguous())


def level1(x, plan: FFTPlan, forward: bool = True):
    """K6 level 1 (``l1`` forward, ``l1_rev`` backward); shapes as in
    :func:`level1_plain`, L = plan.n; returns ``x``'s form."""
    kernel = K6_L1 if forward else K6_L1_REV
    length = plan.n
    require_domain(kernel, plan.kind == FFT_COMPLEX and _col_ok(length), length, plan.kind)
    if takes_plain(kernel.name, x):
        return level1_plain(x, plan, forward)
    b, d1, d2 = shape_of(x)
    m = d2 if forward else d1
    out_shape = (b, d2, d1)
    dev, stride, src, out, dst = complex_io(kernel.name, x, (b, d1, d2), out_shape)
    if (d1 if forward else d2) != length:
        raise ValueError(f"{kernel.name}: columns of length {d1 if forward else d2}, plan N={length}")
    if b and m:
        _launch_columns(kernel, "k6_l1" if forward else "k6_l1_rev", dev, plan, b, m, 4 * stride,
                        in_place_role(kernel, stride), (*src, *dst, stride, b, length, m), None)
    return out


def level2(x, tw: torch.Tensor, plan: FFTPlan, forward: bool = True):
    """K6 level 2 (``l2`` forward, ``l2_rev`` backward) on (B, C, M) with a
    (C, M) complex64 twiddle; returns ``x``'s form."""
    kernel = K6_L2 if forward else K6_L2_REV
    length = plan.n
    require_domain(kernel, plan.kind == FFT_COMPLEX and _col_ok(length), length, plan.kind)
    if takes_plain(kernel.name, x, tw):
        return level2_plain(x, tw, plan, forward)
    b, c, m = shape_of(x)
    if c != length:
        raise ValueError(f"{kernel.name}: columns of length {c}, plan N={length}")
    dev, stride, src, out, dst = complex_io(kernel.name, x, (b, c, m))
    check(f"{kernel.name} twiddle", tw, (c, m), dev, torch.complex64)
    if b and m:
        _launch_columns(kernel, "k6_l2" if forward else "k6_l2_rev", dev, plan, b, m, 4 * stride,
                        in_place_role(kernel, stride), (*src, *dst, stride, b, length, m), tw.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6 level 2 of the real composite: the Hermitian assembly in its store
# (forward) and its load (backward)
# ---------------------------------------------------------------------------


def packed_index(c: int, a: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The map by which K6 level 2 of the real composite stores its
    (C, A/2) grid G into a row's ordered packed planes (C/2, A), and
    l2_rev gathers it (``csrc/composite_fft.cu`` ``PackedColumn``): for grid
    columns k1 in [1, A/2), the (C, A/2 - 1) flat positions and whether the
    point is conjugated there. Point l < C/2 lies at row l, column k1;
    point l >= C/2 at row C-1-l, column A-k1, conjugated (bin k1 + A*k2
    for k1 > A/2 is conj(G[C-1-k2, A-k1])). Grid column 0 has no place:
    packed columns 0 and A/2 hold the DC and Nyquist lines."""
    l = torch.arange(c)[:, None]
    k1 = torch.arange(1, a // 2)[None, :]
    low = l < c // 2
    return torch.where(low, l * a + k1, (c - 1 - l) * a + a - k1), (~low).expand(c, a // 2 - 1)


def hermitian_assembly(gr: torch.Tensor, gi: torch.Tensor, lines: torch.Tensor):
    """The real composite's level-2 grid planes (B, C, A/2) and its (2B, C)
    complex64 DC (rows < B) and Nyquist (rows >= B) line transforms ->
    ordered packed planes ((B, N/2) x2): rows k2 < C/2 hold bins
    k1 + A*k2 for k1 <= A/2 directly; k1 in (A/2, A) comes from
    conj(G[C-1-k2, A-k1]); X[N/2] = G_dc[C/2] (real) goes to im[0]."""
    b, c, half_a = gr.shape
    c2 = c // 2
    g0, gny = lines[:b], lines[b:]
    first_r = torch.cat([g0.real[:, :c2, None], gr[:, :c2, 1:], gny.real[:, :c2, None]], 2)
    first_i = torch.cat([g0.imag[:, :c2, None], gi[:, :c2, 1:], gny.imag[:, :c2, None]], 2)
    sec_r = torch.flip(gr[:, c2:, 1:], (1, 2))
    sec_i = -torch.flip(gi[:, c2:, 1:], (1, 2))
    out_r = torch.cat([first_r, sec_r], 2).reshape(b, c * half_a)
    out_i = torch.cat([first_i, sec_i], 2).reshape(b, c * half_a)
    out_i[:, 0] = g0.real[:, c2]
    return out_r, out_i


def hermitian_grid(yre: torch.Tensor, yim: torch.Tensor, col0: torch.Tensor):
    """Ordered packed planes ((B, N/2) x2) and the (B, C) complex64 grid
    column 0 -> the real composite's level-2 grid planes (B, C, A/2) by
    Hermitian symmetry, the inverse of :func:`hermitian_assembly` on the
    columns k1 in [1, A/2)."""
    b, c = col0.shape
    a = 2 * yre.shape[1] // c
    pr, pi = yre.reshape(b, c // 2, a), yim.reshape(b, c // 2, a)
    mids_r = torch.cat([pr[:, :, 1:a // 2], torch.flip(pr[:, :, a // 2 + 1:], (1, 2))], 1)
    mids_i = torch.cat([pi[:, :, 1:a // 2], -torch.flip(pi[:, :, a // 2 + 1:], (1, 2))], 1)
    return torch.cat([col0.real[:, :, None], mids_r], 2), torch.cat([col0.imag[:, :, None], mids_i], 2)


def level2_packed_plain(pre: torch.Tensor, pim: torch.Tensor, tw: torch.Tensor, plan: FFTPlan, lines: torch.Tensor):
    """Plain version of :func:`level2_packed`: K6 level 2's plain version,
    then :func:`hermitian_assembly`."""
    return hermitian_assembly(*level2_plain((pre, pim), tw, plan, True), lines)


def level2_rev_packed_plain(yre: torch.Tensor, yim: torch.Tensor, col0: torch.Tensor, tw: torch.Tensor,
                            plan: FFTPlan):
    """Plain version of :func:`level2_rev_packed`: :func:`hermitian_grid`,
    then K6 level 2's plain version backward."""
    return level2_plain(hermitian_grid(yre, yim, col0), tw, plan, False)


def _require_packed(kernel: Kernel, plan: FFTPlan, c: int, half_a: int):
    require_domain(kernel, plan.kind == FFT_COMPLEX and _col_ok(plan.n) and plan.n % 2 == 0, plan.n, plan.kind)
    if c != plan.n or half_a < 1:
        raise ValueError(f"{kernel.name}: a grid of {c} x {half_a} columns, plan N={plan.n}")


def level2_packed(pre: torch.Tensor, pim: torch.Tensor, tw: torch.Tensor, plan: FFTPlan, lines: torch.Tensor):
    """K6 level 2 of the real composite, forward: the (B, C, A/2) planes
    after K7a, C = plan.n, twiddled by the (C, A/2) ``tw`` and transformed
    down their columns, stored as the ordered packed planes ((B, N/2) x2),
    grid column 0's bins and X[N/2] from ``lines``, the (2B, C) complex64
    DC and Nyquist line transforms (:func:`hermitian_assembly`'s layout)."""
    b, c, half_a = pre.shape
    _require_packed(K6_L2, plan, c, half_a)
    if takes_plain(K6_L2.name, pre, pim, tw, lines):
        return level2_packed_plain(pre, pim, tw, plan, lines)
    dev = pre.device
    check(f"{K6_L2.name} re", pre, (b, c, half_a), dev)
    check(f"{K6_L2.name} im", pim, (b, c, half_a), dev)
    check(f"{K6_L2.name} twiddle", tw, (c, half_a), dev, torch.complex64)
    check(f"{K6_L2.name} lines", lines, (2 * b, c), dev, torch.complex64)
    out_r = torch.empty((b, c * half_a), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    if b:
        _launch_columns(K6_L2, "k6_l2_packed", dev, plan, b, half_a, 4, in_place_role(K6_L2, 1),
                        (pre.data_ptr(), pim.data_ptr(), out_r.data_ptr(), out_i.data_ptr(), lines.data_ptr(), b, c,
                         half_a), tw.data_ptr())
    return out_r, out_i


def level2_rev_packed(yre: torch.Tensor, yim: torch.Tensor, col0: torch.Tensor, tw: torch.Tensor, plan: FFTPlan):
    """K6 level 2 of the real composite, backward: the (B, C, A/2) grid,
    C = plan.n, gathered from the ordered packed planes ((B, N/2) x2) by
    Hermitian symmetry, its column 0 from ``col0`` ((B, C) complex64),
    then inverse transforms down its columns and the (C, A/2) ``tw`` ->
    (B, C, A/2) planes."""
    b, c = col0.shape
    half_a = yre.shape[-1] // c if c else 0
    _require_packed(K6_L2_REV, plan, c, half_a)
    if takes_plain(K6_L2_REV.name, yre, yim, col0, tw):
        return level2_rev_packed_plain(yre, yim, col0, tw, plan)
    dev = yre.device
    check(f"{K6_L2_REV.name} re", yre, (b, c * half_a), dev)
    check(f"{K6_L2_REV.name} im", yim, (b, c * half_a), dev)
    check(f"{K6_L2_REV.name} twiddle", tw, (c, half_a), dev, torch.complex64)
    check(f"{K6_L2_REV.name} column 0", col0, (b, c), dev, torch.complex64)
    pre = torch.empty((b, c, half_a), dtype=torch.float32, device=dev)
    pim = torch.empty_like(pre)
    if b:
        _launch_columns(K6_L2_REV, "k6_l2_rev_packed", dev, plan, b, half_a, 4, in_place_role(K6_L2_REV, 1),
                        (yre.data_ptr(), yim.data_ptr(), pre.data_ptr(), pim.data_ptr(), col0.data_ptr(), b, c,
                         half_a), tw.data_ptr())
    return pre, pim


# ---------------------------------------------------------------------------
# K7a, K7b: the real composite's level 1
# ---------------------------------------------------------------------------


def rfft_cols_plain(x: torch.Tensor, plan: FFTPlan):
    """Plain version of K7a: (B, A, C) f32 -> packed planes (B, C, A/2) of
    the length-A real FFT of every column."""
    b, a, c = x.shape
    rows = x.transpose(1, 2).reshape(b * c, a)
    re, im = spectrum_to_packed_planes(stockham.rfft(rows, plan))
    return re.reshape(b, c, a // 2), im.reshape(b, c, a // 2)


def irfft_cols_plain(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan):
    """Plain version of K7b: packed planes (B, C, A/2) -> (B, A, C) f32,
    the unscaled inverse of :func:`rfft_cols_plain`."""
    b, c, h = yre.shape
    x = stockham.irfft(packed_planes_to_spectrum(yre, yim), plan).reshape(b, c, 2 * h)
    return x.transpose(1, 2).contiguous()


def _require_real_cols(kernel: Kernel, plan: FFTPlan):
    require_domain(kernel, plan.kind == FFT_REAL and _col_ok(plan.n), plan.n, plan.kind)


def rfft_cols(x: torch.Tensor, plan: FFTPlan):
    """K7a on (B, A, C) f32, A = plan.n -> ((B, C, A/2), (B, C, A/2))."""
    _require_real_cols(K7A, plan)
    if takes_plain(K7A.name, x):
        return rfft_cols_plain(x, plan)
    b, a, c = x.shape
    check("x", x, (b, plan.n, c), x.device)
    yre = torch.empty((b, c, a // 2), dtype=torch.float32, device=x.device)
    yim = torch.empty_like(yre)
    if b and c:
        _launch_columns(K7A, "k7a_rfft_cols", x.device, plan, b, c, 4, in_place_role(K7A, 1),
                        (x.data_ptr(), yre.data_ptr(), yim.data_ptr(), b, a, c),
                        plan.device_tables(x.device).split_tw.data_ptr())
    return yre, yim


def irfft_cols(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan):
    """K7b on packed planes (B, C, A/2), A = plan.n -> (B, A, C) f32."""
    _require_real_cols(K7B, plan)
    if takes_plain(K7B.name, yre, yim):
        return irfft_cols_plain(yre, yim, plan)
    b, c, h = yre.shape
    check("yre", yre, (b, c, plan.n // 2), yre.device)
    check("yim", yim, (b, c, plan.n // 2), yre.device)
    x = torch.empty((b, 2 * h, c), dtype=torch.float32, device=yre.device)
    if b and c:
        _launch_columns(K7B, "k7b_irfft_cols", yre.device, plan, b, c, 4, in_place_role(K7B, 1),
                        (yre.data_ptr(), yim.data_ptr(), x.data_ptr(), b, 2 * h, c),
                        plan.device_tables(yre.device).split_tw.data_ptr())
    return x


# ---------------------------------------------------------------------------
# The composites (rows in, rows out)
# ---------------------------------------------------------------------------


def cfft_rows(x, plan: FFTPlan, forward: bool = True, ordered: bool = True):
    """The complex dispatch (``_cfft_pair_impl``) on (rows, N) complex64
    or a pair of planes: K5 for its sizes and K4 in its domain (natural or
    unordered), the composite above (natural order either way)."""
    n = plan.n
    if hopper_small.in_domain(n):
        return hopper_small.small_cfft_kernel(x, plan, forward)
    if hopper_cfft.in_domain(n):
        return hopper_cfft.cfft_kernel(x, plan, forward, ordered)
    return cfft_composite(x, plan, forward)


@spanned("ops.hopper_composite.cfft_composite")
def cfft_composite(x, plan: FFTPlan, forward: bool = True):
    """Two-level complex FFT of (rows, N) rows (``_cfft_composite_v2``
    :2741): natural order in, natural order out; returns ``x``'s form."""
    n = plan.n
    a, c = split_large(n)
    rows = shape_of(x)[0]
    dev = (x if isinstance(x, torch.Tensor) else x[0]).device
    plan_a, plan_c = cached_plan(a, FFT_COMPLEX), cached_plan(c, FFT_COMPLEX)
    tw = twiddle(n, forward, dev)
    if forward:
        mid = level1(_view(x, (rows, a, c)), plan_a, True)
        y = level2(mid, tw, plan_c, True)
    else:
        mid = level2(_view(x, (rows, c, a)), tw, plan_c, False)
        y = level1(mid, plan_a, False)
    return _view(y, (rows, n))


@spanned("ops.hopper_composite.rfft_composite")
def rfft_composite(x: torch.Tensor, plan: FFTPlan):
    """Two-level real FFT of (rows, N) f32 -> ordered packed planes
    ((rows, N/2) x2) (``_rfft_direct_composite_v2`` :3160)."""
    n = plan.n
    a, c = split_large(n, real=True)
    b = x.shape[0]
    plan_c = cached_plan(c, FFT_COMPLEX)
    nytr, nyti = _nyquist(n, str(x.device))

    # Level 1: packed real FFTs of the columns -> (B, C, A/2) planes.
    pre, pim = rfft_cols(x.reshape(b, a, c), cached_plan(a, FFT_REAL))

    # The DC and level-1 Nyquist lines (column 0: DC in re, Nyquist in im);
    # the Nyquist line takes the half-bin modulation before its C-FFT.
    dcrow, nyrow = pre[:, :, 0], pim[:, :, 0]
    lines = torch.complex(torch.cat([dcrow, nyrow * nytr]),
                          torch.cat([torch.zeros_like(dcrow), nyrow * nyti]))
    g = cfft_rows(lines, plan_c, True, True)

    # Level 2: twiddle, then C-FFTs down the A/2 columns, stored as the
    # ordered packed planes (the Hermitian assembly), column 0 from g.
    return level2_packed(pre, pim, real_twiddle(n, True, x.device), plan_c, g)


@spanned("ops.hopper_composite.irfft_composite")
def irfft_composite(yre: torch.Tensor, yim: torch.Tensor, plan: FFTPlan):
    """Unscaled inverse of :func:`rfft_composite`: ordered packed planes
    (rows, N/2) x2 -> (rows, N) f32 (``_irfft_direct_composite_v2`` :3213)."""
    n = plan.n
    a, c = split_large(n, real=True)
    b, half_a = yre.shape[0], a // 2
    plan_c = cached_plan(c, FFT_COMPLEX)
    nytr, nyti = _nyquist(n, str(yre.device))

    nyq = yim[:, :1]  # X[N/2]
    pr, pi = yre.reshape(b, c // 2, a), yim.reshape(b, c // 2, a)
    # The DC line's imaginary part, its k2 = 0 (where X[N/2] is packed) zero.
    pi0 = torch.cat([torch.zeros_like(nyq), pi[:, 1:, 0]], 1)

    # Column 0 (DC line): direct rows, then conj-flipped rows with the
    # packed global Nyquist at k2 = C/2.
    col0_r = torch.cat([pr[:, :, 0], nyq, torch.flip(pr[:, 1:, 0], (1,))], 1)
    col0_i = torch.cat([pi0, torch.zeros_like(nyq), -torch.flip(pi0[:, 1:], (1,))], 1)
    # Nyquist line (column A/2): direct rows, then conj-flipped rows.
    ny = torch.complex(torch.cat([pr[:, :, half_a], torch.flip(pr[:, :, half_a], (1,))], 1),
                       torch.cat([pi[:, :, half_a], -torch.flip(pi[:, :, half_a], (1,))], 1))

    # The level-1 Nyquist row in c-space (backward C-FFT, conjugate
    # half-bin modulation), folded into column 0 as fwd(ny_c)/C so that the
    # level-2 inverse emits (DC_c, ny_c) in that column.
    u = cfft_rows(ny, plan_c, False, True)
    ny_c = u.real * nytr + u.imag * nyti
    f = cfft_rows(torch.complex(ny_c / float(c), torch.zeros_like(ny_c)), plan_c, True, True)
    col0 = torch.complex(col0_r - f.imag, col0_i + f.real)

    # Level 2 inverse on the grid gathered from the packed planes by
    # Hermitian symmetry, then the column-blocked real inverse of level 1.
    pre, pim = level2_rev_packed(yre, yim, col0, real_twiddle(n, False, yre.device), plan_c)
    return irfft_cols(pre, pim, cached_plan(a, FFT_REAL)).reshape(b, n)
