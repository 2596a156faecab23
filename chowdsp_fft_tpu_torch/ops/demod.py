"""The quadrature FM discriminator on complex rows (..., T): ``y[n] = gain *
atan2(Im z[n] conj(z[n-1]), Re z[n] conj(z[n-1]))`` in float32, with no
phase history before sample 0 (the elementwise ops of
``chowdsp_fft_tpu/stream/demod.py``).

- ``fm_demod``: the CUDA kernel (``csrc/demod.cu``) for a CUDA tensor,
  the plain version on the CPU or ``meta``;
- ``fm_demod_kernel``: one launch of the kernel, which reads each row
  where it lies and writes y[0] = 0;
- ``fm_demod_plain``: the same function in torch ops, on any device (its
  sample 0 is atan2 of signed zeros: 0 or +-gain*pi).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = ["KERNELS", "FM_DEMOD", "fm_demod", "fm_demod_kernel", "fm_demod_plain", "demod_layout"]

# The port's kernels that replace no Pallas kernel, apart from
# ``hopper_fft.KERNELS`` (the ports of the JAX package's kernels).
FM_DEMOD = _cuda.Kernel(
    "fm_demod_kernel",
    "chowdsp_fft_tpu_torch/csrc/demod.cu",
    "none: the JAX package leaves the discriminator to XLA (chowdsp_fft_tpu/stream/demod.py, fm_demod); "
    "here it replaces 12 strided elementwise torch ops",
)
KERNELS = (FM_DEMOD,)

ROWS_FAST, TIME_FAST = 0, 1  # the kernel's layouts: which axis a warp's threads span
RUN = 4  # steps a thread walks where the threads span rows (kRun)
SEGMENT = 8 * 32 * 2  # samples a warp walks where the threads span samples (kSegment)


def demod_layout(rows: int, row_stride: int, sample_stride: int) -> int:
    """The kernel's layout: the threads span rows (``ROWS_FAST``) where rows
    lie closer together than samples, else samples (``TIME_FAST``). The C
    entry refuses any other."""
    return ROWS_FAST if rows > 1 and row_stride < sample_stride else TIME_FAST


def _batch(z: torch.Tensor) -> tuple[int, int] | None:
    """(size, stride) of z's leading dimensions (all but the last two)
    folded into one, or None where no one stride describes them."""
    size, stride = 1, 0
    for n, s in reversed(list(zip(z.shape[:-2], z.stride()[:-2]))):
        if n == 1:
            continue
        if size == 1:
            size, stride = n, s
        elif s == stride * size:
            size *= n
        else:
            return None
    return size, stride


def _dims(t: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """(batch, rows, T, batch stride, row stride, sample stride) of (..., T)."""
    batch, bs = _batch(t)
    rows, rs = (t.shape[-2], t.stride(-2)) if t.dim() > 1 else (1, 0)
    return batch, rows, t.shape[-1], bs, rs, t.stride(-1)


def fm_demod(z: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """complex64 (..., T) -> float32 (..., T). A CUDA tensor takes
    :func:`fm_demod_kernel` (or it raises); the CPU and ``meta`` take
    :func:`fm_demod_plain`."""
    if z.device.type == "meta" or _cuda.takes_plain(FM_DEMOD.name, z):
        return fm_demod_plain(z, gain)
    return fm_demod_kernel(z.resolve_conj(), gain)


def fm_demod_kernel(z: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """One launch of ``csrc/demod.cu`` on complex64 CUDA rows ``z`` (...,
    T), at any strides whose leading dimensions fold into one (any other
    layout is made contiguous first): a new float32 tensor laid out as z
    (``empty_like``), y[..., 0] = 0. Refuses tensors of another type or
    device and inputs that require grad (``autodiff.FMDemod``
    differentiates), on any device."""
    if z.dim() == 0:
        raise ValueError(f"{FM_DEMOD.name}: expected (..., T), got a 0-d tensor")
    _cuda.check("z", z, tuple(z.shape), z.device, dtype=torch.complex64, contiguous=False)
    _cuda.require_cuda(FM_DEMOD.name, z)
    if _batch(z) is None:
        z = z.contiguous()
    y = torch.empty_like(z, dtype=torch.float32)
    if y.numel():
        batch, rows, t, *zs = _dims(z)
        _, _, _, *ys = _dims(y)
        _cuda.launch(FM_DEMOD, "fm_demod", z.device, z.data_ptr(), y.data_ptr(), batch, rows, t, *zs, *ys,
                     float(gain), demod_layout(rows, zs[1], zs[2]))
    return y


def fm_demod_plain(z: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """:func:`fm_demod` in torch ops (differentiable), on any device."""
    zr, zi = z.real, z.imag
    pr = F.pad(zr[..., :-1], (1, 0))
    pi = F.pad(zi[..., :-1], (1, 0))
    # z[n] * conj(z[n-1])
    dr = zr * pr + zi * pi
    di = zi * pr - zr * pi
    return (gain * torch.atan2(di, dr)).to(torch.float32)
