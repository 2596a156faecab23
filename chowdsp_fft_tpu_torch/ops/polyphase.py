"""Polyphase FIR decimation on (B, T) rows: ``y[b, m] = sum_k h[k] x[b, m f
- k]`` with zero initial state, for m < T // f (the strided
``lax.conv_general_dilated`` of ``chowdsp_fft_tpu/stream/polyphase.py``).

- ``decimate``: the CUDA kernel (``csrc/polyphase.cu``) for a CUDA tensor,
  the plain version on the CPU or ``meta``;
- ``decimate_kernel``: one launch of the kernel, which reads each row
  where it lies (no framing, no cuDNN);
- ``decimate_plain``: the same function through ``F.conv1d`` on
  overlapped frames, on any device;
- ``fp32_convolutions``: runs cuDNN's float32 convolutions without TF32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import _cuda
from ._cuda import MAX_DECIM_FACTOR, MAX_DECIM_TAPS

__all__ = ["KERNELS", "DECIMATE", "decimate", "decimate_kernel", "decimate_plain", "decimate_geometry",
           "fp32_convolutions"]

# The port's kernels that replace no Pallas kernel, apart from
# ``hopper_fft.KERNELS`` (the ports of the JAX package's kernels).
DECIMATE = _cuda.Kernel(
    "polyphase_decimate_kernel",
    "chowdsp_fft_tpu_torch/csrc/polyphase.cu",
    "none: the JAX package leaves the strided convolution to XLA (chowdsp_fft_tpu/stream/polyphase.py, "
    "_conv_valid); here it replaces cuDNN's direct convolution and the framing",
)
KERNELS = (DECIMATE,)

OUTPUTS_PER_THREAD = 8  # the kernel's kOut
THREADS = (128, 64, 32)  # the most threads whose spans fit, in this order
MAX_ROWS_PER_BLOCK = 8  # rows a block stages together where samples are not consecutive
SMEM_LIMIT = 48 * 1024  # dynamic shared memory allowed without opting in


@contextlib.contextmanager
def fp32_convolutions():
    """Run the enclosed cuDNN convolutions in full float32 (no TF32) and
    restore the caller's setting afterwards."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def decimate_geometry(factor: int, taps: int, consecutive: bool = True, rows: int = 1) -> tuple[int, int, int, int]:
    """(threads, rows a block, taps a phase, shared bytes) of the kernel's
    block. The taps of each phase are padded to whole windows of 8. Where
    samples are not ``consecutive`` (a sample stride other than 1), a
    block stages up to 8 rows together (no more than ``rows``' next power
    of two), so that a warp reads whole sectors of neighbouring rows;
    else one. Then the most threads whose staged spans (8 outputs a
    thread, f samples an output, 4 pad floats after every 32 of a phase)
    and taps fit in 48 KB. The C entry refuses any other block."""
    q = -(-(-(-taps // factor)) // OUTPUTS_PER_THREAD) * OUTPUTS_PER_THREAD
    rb = 1
    while not consecutive and rb < MAX_ROWS_PER_BLOCK and rb < rows:
        rb *= 2
    while rb >= 1:
        for threads in THREADS:
            seg = threads // rb * OUTPUTS_PER_THREAD + q
            smem = 4 * factor * (q + rb * (seg + 4 * (seg // 32)))
            if smem <= SMEM_LIMIT:
                return threads, rb, q, smem
        rb //= 2
    raise ValueError(f"{DECIMATE.name}: factor {factor} with {taps} taps has no block within {SMEM_LIMIT} B")


def _require_domain(factor: int, taps: int):
    _cuda.require_domain(DECIMATE, 1 <= factor <= MAX_DECIM_FACTOR, factor, "decimation factor")
    _cuda.require_domain(DECIMATE, 1 <= taps <= MAX_DECIM_TAPS, taps, "filter of taps")


def decimate(x: torch.Tensor, h: torch.Tensor, factor: int, block: int = 4096) -> torch.Tensor:
    """(B, T) float32 rows filtered by ``h`` (taps,) and decimated by
    ``factor`` -> (B, T // factor), zero initial state. A CUDA tensor
    takes :func:`decimate_kernel` (or it raises); the CPU and ``meta``
    take :func:`decimate_plain` with its ``block``."""
    if x.device.type == "meta" or _cuda.takes_plain(DECIMATE.name, x):
        return decimate_plain(x, h, factor, block)
    return decimate_kernel(x, h, factor)


def decimate_kernel(x: torch.Tensor, h: torch.Tensor, factor: int) -> torch.Tensor:
    """One launch of ``csrc/polyphase.cu`` on CUDA rows ``x`` (B, T), at any
    strides (the kernel reads each row where it lies), and taps ``h``
    (taps,): a new contiguous (B, T // factor) tensor. Refuses a factor or
    a filter outside the kernel's domain (on any device), tensors of
    another device or type, and inputs that require grad
    (``autodiff.PolyphaseDecimate`` differentiates)."""
    taps = h.shape[-1]
    _require_domain(factor, taps)
    _cuda.require_cuda(DECIMATE.name, x)
    h = h.contiguous()
    rows, t = x.shape
    dev = x.device
    _cuda.check("x", x, (rows, t), dev, align=4, contiguous=False)
    _cuda.check("h", h, (taps,), dev, align=4)
    y = torch.empty((rows, t // factor), dtype=torch.float32, device=dev)
    if y.numel():
        row_stride, sample_stride = x.stride()
        threads, rows_per_block, _, _ = decimate_geometry(factor, taps, sample_stride == 1, rows)
        _cuda.launch(DECIMATE, "polyphase_decimate", dev, x.data_ptr(), h.data_ptr(), y.data_ptr(), rows, t,
                     row_stride, sample_stride, factor, taps, threads, rows_per_block)
    return y


def _conv_valid(x: torch.Tensor, h: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided valid convolution of (B, T) with (taps,) -> (B, T_out)."""
    with fp32_convolutions():
        out = F.conv1d(x[:, None, :], torch.flip(h, (-1,))[None, None, :], stride=stride)
    return out[:, 0, :]


def decimate_plain(x: torch.Tensor, h: torch.Tensor, factor: int, block: int = 4096) -> torch.Tensor:
    """:func:`decimate` through ``F.conv1d``: rows longer than ``2 * block``
    are framed into overlapped ``block``-sample rows first
    (``stream.ols``'s framing), so the convolution runs with a large batch
    dimension."""
    # stream.ols imports ops.autodiff, which imports this module.
    from ..stream.ols import _frame_overlap

    taps = h.shape[-1]
    b, t = x.shape
    if t <= 2 * block:
        return _conv_valid(F.pad(x, (taps - 1, 0)), h, stride=factor)[..., : t // factor]  # zero initial state
    blk = block - block % factor  # frame starts stay phase-aligned
    frames = _frame_overlap(x, blk, taps - 1)  # (B, nb, taps-1+blk)
    nb = frames.shape[-2]
    y = _conv_valid(frames.reshape(b * nb, -1), h, stride=factor)
    return y.reshape(b, nb * (blk // factor))[..., : t // factor]
