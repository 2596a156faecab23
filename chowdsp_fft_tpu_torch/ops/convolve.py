"""Frequency-domain convolution helpers (counterpart of
``chowdsp_fft_tpu/ops/convolve.py``).

- ``convolve_accumulate``: ab + a * b * scaling on spectra;
- ``convolve_accumulate_packed``: the same on packed planes, with the
  DC·DC / Nyq·Nyq bin-0 patch-up (one CUDA kernel,
  ``csrc/packed_product.cu``, on the card);
- ``convolve_accumulate_partitioned``: the offline frequency-domain delay
  line, every partition's packed product summed along the block axis (one
  CUDA kernel, ``csrc/partitioned_accumulate.cu``, on the card);
- ``accumulate``: a + b.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import _cuda
from ..utils.tracing import spanned

__all__ = [
    "KERNELS",
    "convolve_accumulate",
    "PACKED_PRODUCT",
    "convolve_accumulate_packed",
    "convolve_accumulate_packed_plain",
    "packed_product_kernel",
    "takes_kernel",
    "convolve_accumulate_partitioned",
    "convolve_accumulate_partitioned_plain",
    "multiply_spectra",
    "accumulate",
]


def _is_unit(scaling) -> bool:
    return isinstance(scaling, (int, float)) and scaling == 1.0


def _scale(scaling, device):
    """A number stays a Python float (no host-to-device copy per call); a
    tensor becomes float32 on ``device``."""
    if isinstance(scaling, torch.Tensor):
        return scaling.to(dtype=torch.float32, device=device)
    return float(scaling)


# The port's kernels that replace no Pallas kernel, apart from
# ``hopper_fft.KERNELS`` (the ports of the JAX package's kernels).
PARTITIONED = _cuda.Kernel(
    "partitioned_accumulate_kernel",
    "chowdsp_fft_tpu_torch/csrc/partitioned_accumulate.cu",
    "none: the JAX package leaves the FDL sum to XLA (chowdsp_fft_tpu/stream/ols.py:177-195)",
)
PACKED_PRODUCT = _cuda.Kernel(
    "packed_product_kernel",
    "chowdsp_fft_tpu_torch/csrc/packed_product.cu",
    "none: the JAX package leaves the packed product to XLA (chowdsp_fft_tpu/ops/convolve.py:32); "
    "here it replaces 12 plain-torch ops",
)
KERNELS = (PARTITIONED, PACKED_PRODUCT)

PRODUCT_THREADS = 256  # threads a block of the packed product (kThreads)
PRODUCT_WIDE = 4  # slots a unit where the layout allows 16-byte accesses (kWide)
PRODUCT_MIN_BLOCKS = 4  # blocks an SM at least (kMinBlocks: 64 registers a thread at most)
H100_SMS = 132
# Threads of the packed product resident on an H100 SXM at the least:
# ``__launch_bounds__(kThreads, kMinBlocks)`` holds a thread to 64
# registers, so 4 blocks of 256 fit an SM. The frame axis is cut into
# chunks only where whole axes give fewer than 8 units a resident thread,
# and the grid-stride loop runs at most 8 full waves of blocks.
RESIDENT_THREADS = PRODUCT_MIN_BLOCKS * PRODUCT_THREADS * H100_SMS
PRODUCT_WAVES = 8
PRODUCT_BLOCKS = PRODUCT_WAVES * RESIDENT_THREADS // PRODUCT_THREADS


def takes_kernel(a, b, ab=None, scaling=1.0) -> bool:
    """The packed product's routing rule, by input: the kernel where every
    plane lies on one CUDA device and ``scaling`` is a number or a
    one-element tensor that needs no grad; the plain version on the CPU,
    on ``meta``, and for any other tensor ``scaling``."""
    if isinstance(scaling, torch.Tensor) and (scaling.numel() != 1 or scaling.requires_grad):
        return False
    if a[0].device.type == "meta":
        return False
    return not _cuda.takes_plain(PACKED_PRODUCT.name, a, b, *(() if ab is None else (ab,)))


@spanned("ops.convolve.accumulate_packed")
def convolve_accumulate_packed(
    a: tuple[torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor],
    ab: tuple[torch.Tensor, torch.Tensor] | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ab + a * b * scaling`` on packed real-spectrum planes, as new
    planes (``ab`` is never updated in place).

    Bin 0 packs two purely-real bins (DC in re[0], Nyquist in im[0]), so
    the product there is two real products. Valid in ordered and unordered
    bin order alike: bin 0 is index 0 in both. Where :func:`takes_kernel`
    (CUDA planes; a number or a one-element tensor ``scaling``), one launch
    of ``csrc/packed_product.cu`` (:func:`packed_product_kernel`, bit for
    bit the plain version), through ``autodiff.PackedProduct`` where grad
    mode is on and a plane requires grad (under ``no_grad`` such planes are
    detached); otherwise :func:`convolve_accumulate_packed_plain`."""
    if not takes_kernel(a, b, ab, scaling):
        return convolve_accumulate_packed_plain(a, b, ab, scaling)
    if any(t.requires_grad for pair in (a, b, ab or ()) for t in pair):
        if torch.is_grad_enabled():
            from . import autodiff  # autodiff imports this module

            return autodiff.PackedProduct.apply(*a, *b, *((None, None) if ab is None else ab), scaling)
        a, b, ab = (None if pair is None else tuple(t.detach() for t in pair) for pair in (a, b, ab))
    return packed_product_kernel(a, b, ab, scaling)


def convolve_accumulate_packed_plain(
    a: tuple[torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor],
    ab: tuple[torch.Tensor, torch.Tensor] | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`convolve_accumulate_packed` in torch ops (differentiable), on
    any device: the product, its slot-0 patch-up, the scale, then ``ab +``."""
    a_re, a_im = a
    b_re, b_im = b
    pr = a_re * b_re - a_im * b_im
    pi = a_re * b_im + a_im * b_re
    pr = torch.cat([a_re[..., :1] * b_re[..., :1], pr[..., 1:]], dim=-1)  # DC * DC
    pi = torch.cat([a_im[..., :1] * b_im[..., :1], pi[..., 1:]], dim=-1)  # Nyq * Nyq
    if not _is_unit(scaling):
        s = _scale(scaling, pr.device)
        pr, pi = pr * s, pi * s
    if ab is None:
        return pr, pi
    return ab[0] + pr, ab[1] + pi


def product_geometry(outer: int, inner: int, vecs: int) -> tuple[int, int]:
    """(frames a unit, blocks) of the packed product's launch: whole frame
    axes as units unless they give fewer than ``PRODUCT_WAVES`` units a
    resident thread (the axis is then cut into chunks), and a grid of one
    thread a unit, at most ``PRODUCT_BLOCKS``."""
    chunks = min(inner, -(-PRODUCT_WAVES * RESIDENT_THREADS // (outer * vecs)))
    frames = -(-inner // chunks)
    units = outer * -(-inner // frames) * vecs
    return frames, min(-(-units // PRODUCT_THREADS), PRODUCT_BLOCKS)


def packed_product_kernel(
    a: tuple[torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor],
    ab: tuple[torch.Tensor, torch.Tensor] | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/packed_product.cu`` on float32 CUDA planes
    (..., M): new planes ``ab + scaling * a (.) b`` at the broadcast shape,
    bit for bit :func:`convolve_accumulate_packed_plain`. ``a`` and ``ab``
    are read as contiguous (outer, frames, M) and ``b`` as (outer, M),
    broadcast over the frames (:func:`product_operands`: a copy only where
    a plane is not laid out so). Refuses planes of another dtype or
    device, a pair whose planes differ in shape, 0-d planes, a tensor
    ``scaling`` of more than one element, and inputs that require grad
    (``autodiff.PackedProduct`` differentiates), on any device."""
    if isinstance(scaling, torch.Tensor) and scaling.numel() != 1:
        raise ValueError(f"{PACKED_PRODUCT.name}: a tensor scaling has one element, got {tuple(scaling.shape)}")
    pairs = [("a", a), ("b", b)] + ([] if ab is None else [("ab", ab)])
    dev = a[0].device
    for name, (re, im) in pairs:
        if re.dim() == 0:
            raise ValueError(f"{PACKED_PRODUCT.name}: expected (..., M) planes, got a 0-d {name}")
        for part, t in (("re", re), ("im", im)):
            _cuda.check(f"{name} {part}", t, tuple(re.shape), dev, align=4, contiguous=False)
    _cuda.require_cuda(PACKED_PRODUCT.name, *(p for _, p in pairs))
    shape = out = _broadcast(re.shape for _, (re, _) in pairs)
    s = None
    if isinstance(scaling, torch.Tensor):
        s = _scale(scaling, dev)
        _cuda.check("scaling", s, tuple(s.shape), dev, align=4)
        out = _broadcast((shape, scaling.shape))
    yre = torch.empty(shape, dtype=torch.float32, device=dev)
    yim = torch.empty_like(yre)
    if yre.numel():
        planes, outer, inner = product_operands(shape, a, b, ab)
        m = shape[-1]
        width = product_width(m, [*planes, yre, yim])
        frames, blocks = product_geometry(outer, inner, m // width)
        cre, cim = (None, None) if ab is None else (planes[4].data_ptr(), planes[5].data_ptr())
        _cuda.launch(PACKED_PRODUCT, "packed_product", dev, *(t.data_ptr() for t in planes[:4]), cre, cim,
                     yre.data_ptr(), yim.data_ptr(), outer, inner, m, frames, width,
                     1.0 if s is not None else float(scaling), None if s is None else s.data_ptr(), blocks)
    return (yre, yim) if out == shape else (yre.reshape(out), yim.reshape(out))


def _broadcast(shapes) -> torch.Size:
    """``torch.broadcast_shapes`` of torch.Size objects through torch's own
    C++ rule, without the Python version's symbolic-shape guards (~20 µs of
    host time a call)."""
    return functools.reduce(torch._C._infer_size, shapes)


def product_operands(shape: torch.Size, a, b, ab=None) -> tuple[list[torch.Tensor], int, int]:
    """The planes as the packed product reads them at the broadcast
    ``shape`` (..., M): ([a re, a im, b re, b im, ab re, ab im], outer,
    frames). Where b varies along a prefix of the leading dimensions and is
    broadcast along the rest (a filter per stream, (S, 1, M) against
    (S, F, M); one filter for all, (M,)), outer is that prefix's size and
    b is read as (outer, M) rows; otherwise b is copied to the whole shape
    and frames is 1. ``a`` and ``ab`` are made contiguous at ``shape``
    (``expand(...).contiguous()``: no copy where they already are)."""
    lead = shape[:-1]
    bshape = (1,) * (len(shape) - b[0].dim()) + tuple(b[0].shape)
    k = max((i + 1 for i, n in enumerate(bshape[:-1]) if n != 1), default=0)
    if bshape[-1] == shape[-1] and tuple(bshape[:k]) == tuple(lead[:k]):
        outer = math.prod(lead[:k])
        bs = [t.reshape(outer, shape[-1]).contiguous() for t in b]
    else:
        k = len(lead)
        outer = math.prod(lead)
        bs = [_dense(t, shape) for t in b]
    planes = [_dense(t, shape) for t in a] + bs + [_dense(t, shape) for t in ab or ()]
    return planes, outer, math.prod(lead[k:])


def _dense(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``t`` contiguous at ``shape``: no copy, and no new view, where it
    already is."""
    return (t if t.shape == shape else t.expand(shape)).contiguous()


def product_width(m: int, tensors: list[torch.Tensor]) -> int:
    """Slots a unit of the packed product: ``PRODUCT_WIDE`` (16-byte
    accesses) where M and every plane's address are whole float4s, else 1."""
    wide = m % PRODUCT_WIDE == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return PRODUCT_WIDE if wide else 1


THREADS = 128  # slots of a block (the kernel's kThreads)
RING = 8  # partitions of a register sub-ring
MAX_GROUPS = 4  # sub-rings a thread holds: 32 partitions
# Blocks that fill the card a few times over: 8 for each of an H100 SXM's
# 132 SMs. At 1-4 sub-rings a thread holds 96, 128, 168 or 252 registers
# (ptxas), so 5, 4, 3 or 2 blocks of 128 threads reside on an SM, and 1056
# blocks are 1.6, 2, 2.7 or 4 waves. Streams split into runs only below it.
FILL_BLOCKS = 8 * H100_SMS


def partitioned_geometry(streams: int, nb: int, m: int, partitions: int) -> tuple[int, int]:
    """(sub-rings, blocks a run) of the kernel's launch: enough sub-rings
    of 8 for the partitions that reach an output (at most 4; more
    partitions take further passes), and whole streams as runs unless
    there are too few blocks to fill the card; a run is then cut, but to
    no fewer than twice the partitions it holds in registers (each run
    re-reads that many rows before it)."""
    groups = min(MAX_GROUPS, -(-min(partitions, nb) // RING))
    per_run = streams * -(-m // THREADS)
    runs = min(-(-FILL_BLOCKS // per_run), max(1, nb // (2 * RING * groups)))
    return groups, -(-nb // runs)


def _lead(t: torch.Tensor, lead: torch.Size) -> torch.Tensor:
    """(..., rows, m) planes broadcast to ``lead`` leading dims, as
    (streams, rows, m); a copy only where they broadcast."""
    return t.expand(*lead, *t.shape[-2:]).reshape(-1, *t.shape[-2:]).contiguous()


@spanned("ops.convolve.accumulate_partitioned")
def convolve_accumulate_partitioned(
    x: tuple[torch.Tensor, torch.Tensor],
    h: tuple[torch.Tensor, torch.Tensor],
    scaling: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The offline FDL on packed planes: for every block b,
    ``Y[..., b, :] = scaling * sum_p X[..., b - p, :] (.) H[..., p, :]``
    over the partitions p <= b, (.) the packed product of
    :func:`convolve_accumulate_packed`.

    ``x``: (..., nb, M) block spectra; ``h``: (..., P, M) partition
    spectra, one filter for all streams ((P, M)) or leading dims that
    broadcast against x's. Returns new (..., nb, M) planes. On a CUDA
    tensor it launches ``csrc/partitioned_accumulate.cu`` (a filter that
    broadcasts other than whole is first copied to one per stream), or
    raises; on the CPU or ``meta`` it runs
    :func:`convolve_accumulate_partitioned_plain`."""
    xre, xim = x
    hre, him = h
    dev = xre.device
    if dev.type == "meta" or _cuda.takes_plain(PARTITIONED.name, xre):
        return convolve_accumulate_partitioned_plain(x, h, scaling)
    nb, m = xre.shape[-2:]
    partitions = hre.shape[-2]
    lead = torch.broadcast_shapes(xre.shape[:-2], hre.shape[:-2])
    xre, xim = _lead(xre, lead), _lead(xim, lead)
    shared = math.prod(hre.shape[:-2]) == 1
    hre, him = (t.reshape(1, partitions, m).contiguous() if shared else _lead(t, lead) for t in (hre, him))
    streams = xre.shape[0]
    for name, t, rows in (("xre", xre, nb), ("xim", xim, nb), ("hre", hre, partitions), ("him", him, partitions)):
        _cuda.check(name, t, (t.shape[0], rows, m), dev, align=4)
    yre = torch.empty((streams, nb, m), dtype=torch.float32, device=dev)
    yim = torch.empty_like(yre)
    if yre.numel():
        groups, run = partitioned_geometry(streams, nb, m, partitions)
        _cuda.launch(PARTITIONED, "partitioned_accumulate", dev,
                     xre.data_ptr(), xim.data_ptr(), hre.data_ptr(), him.data_ptr(), yre.data_ptr(), yim.data_ptr(),
                     streams, nb, m, partitions, int(shared), groups, run, float(scaling))
    return yre.reshape(*lead, nb, m), yim.reshape(*lead, nb, m)


def convolve_accumulate_partitioned_plain(
    x: tuple[torch.Tensor, torch.Tensor],
    h: tuple[torch.Tensor, torch.Tensor],
    scaling: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`convolve_accumulate_partitioned` in plain torch: per
    partition, the block spectra shifted down p blocks (zeros before) and
    accumulated with :func:`convolve_accumulate_packed_plain`."""
    xre, xim = x
    nb = xre.shape[-2]
    acc = None
    for p in range(min(h[0].shape[-2], nb)):
        # Partitions with no source block (IR longer than the signal)
        # contribute nothing; p = 0 always runs since nb >= 1.
        if p == 0:
            xr_p, xi_p = xre, xim
        else:
            xr_p = F.pad(xre[..., : nb - p, :], (0, 0, p, 0))
            xi_p = F.pad(xim[..., : nb - p, :], (0, 0, p, 0))
        hr, hi = h[0][..., p, :], h[1][..., p, :]
        if hr.ndim > 1:
            # per-stream filters broadcast below the block axis
            hr, hi = hr[..., None, :], hi[..., None, :]
        acc = convolve_accumulate_packed_plain((xr_p, xi_p), (hr, hi), ab=acc, scaling=scaling)
    return acc


def convolve_accumulate(
    a: torch.Tensor,
    b: torch.Tensor,
    ab: torch.Tensor | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """Return ``ab + a * b * scaling`` over frequency-domain tensors
    (ordered or unordered: the op is order-independent)."""
    prod = a * b
    if not _is_unit(scaling):
        prod = prod * _scale(scaling, prod.device)
    if ab is None:
        return prod
    return ab + prod


def multiply_spectra(a: torch.Tensor, b: torch.Tensor, scaling: float | torch.Tensor = 1.0) -> torch.Tensor:
    """Scaled spectral product (convolve_accumulate with zero accumulator)."""
    return convolve_accumulate(a, b, ab=None, scaling=scaling)


def accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of two signals."""
    return a + b
