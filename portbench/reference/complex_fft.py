"""The complex FFT in float64, unscaled as upstream's: the forward
transform is X[k] = sum_n x[n] e^{-2 pi i k n / N} along the last axis,
and the unscaled backward transform of X returns N x (so a forward then
a backward round trip is N x, with no 1/N anywhere)."""

from __future__ import annotations

import torch

# complex128 takes no TF32 path; the flags are cleared all the same, so
# that nothing computed beside the reference in this process takes one
# unasked.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def fft(x: torch.Tensor) -> torch.Tensor:
    """(..., N) complex rows -> complex128 (..., N), the unscaled forward
    spectrum in natural order (bin k at position k)."""
    return torch.fft.fft(x.to(torch.complex128), dim=-1)
