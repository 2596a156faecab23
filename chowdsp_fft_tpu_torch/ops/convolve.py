"""Frequency-domain convolution helpers (counterpart of
``chowdsp_fft_tpu/ops/convolve.py``).

- ``convolve_accumulate``: ab + a * b * scaling on spectra;
- ``convolve_accumulate_packed``: the same on packed planes, with the
  DC·DC / Nyq·Nyq bin-0 patch-up;
- ``convolve_accumulate_partitioned``: the offline frequency-domain delay
  line, every partition's packed product summed along the block axis (one
  CUDA kernel, ``csrc/partitioned_accumulate.cu``, on the card);
- ``accumulate``: a + b.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _cuda
from ..utils.tracing import spanned

__all__ = [
    "KERNELS",
    "convolve_accumulate",
    "convolve_accumulate_packed",
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


@spanned("ops.convolve.accumulate_packed")
def convolve_accumulate_packed(
    a: tuple[torch.Tensor, torch.Tensor],
    b: tuple[torch.Tensor, torch.Tensor],
    ab: tuple[torch.Tensor, torch.Tensor] | None = None,
    scaling: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ab += a * b * scaling`` on packed real-spectrum planes.

    Bin 0 packs two purely-real bins (DC in re[0], Nyquist in im[0]), so
    the product there is two real products. Valid in ordered and unordered
    bin order alike: bin 0 is index 0 in both."""
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


# The port's kernels that replace no Pallas kernel, apart from
# ``hopper_fft.KERNELS`` (the ports of the JAX package's kernels).
PARTITIONED = _cuda.Kernel(
    "partitioned_accumulate_kernel",
    "chowdsp_fft_tpu_torch/csrc/partitioned_accumulate.cu",
    "none: the JAX package leaves the FDL sum to XLA (chowdsp_fft_tpu/stream/ols.py:177-195)",
)
KERNELS = (PARTITIONED,)

THREADS = 128  # slots of a block (the kernel's kThreads)
RING = 8  # partitions of a register sub-ring
MAX_GROUPS = 4  # sub-rings a thread holds: 32 partitions
# Blocks that fill the card a few times over: 8 for each of an H100 SXM's
# 132 SMs. At 1-4 sub-rings a thread holds 96, 128, 168 or 252 registers
# (ptxas), so 5, 4, 3 or 2 blocks of 128 threads reside on an SM, and 1056
# blocks are 1.6, 2, 2.7 or 4 waves. Streams split into runs only below it.
H100_SMS = 132
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
    accumulated with :func:`convolve_accumulate_packed`."""
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
        acc = convolve_accumulate_packed((xr_p, xi_p), (hr, hi), ab=acc, scaling=scaling)
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
